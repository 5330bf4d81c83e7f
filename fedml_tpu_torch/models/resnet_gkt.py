"""FedGKT's split ResNets: a small client feature extractor and a large server
model. The counterpart of ``fedml_tpu/models/resnet_gkt.py`` (reference
fedml_api/model/cv/resnet56_gkt/{resnet_client.py:230 resnet8_56,
resnet_server.py:200 resnet56_server}).

The client is the CIFAR stem (a 3x3 convolution, padding 1, no bias, then
BatchNorm and ReLU) and ``num_blocks`` stage-1 bottleneck blocks with an
auxiliary head; it returns ``(logits, features)``, the features NCHW
``[B, 64, H, W]``. The server is the ResNet's stages over those features
(the reference's forward with its stem commented out,
resnet_server.py:186-198), then the pool and the linear head. Both use the
port's :class:`~fedml_tpu_torch.models.resnet.BottleneckBlock` and its
flax-semantics BatchNorm. The client takes NHWC images, the server NCHW
features.

:func:`load_reference_client_state` reads a torch ``.pth`` checkpoint of
the client (FedGKT's warm start, main_fedgkt.py:124-167) onto the port's
client, matching tensors by kind in the file's order, as the JAX package's
``utils/torch_import.py`` matches them onto the flax tree.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.common import BatchNorm
from fedml_tpu_torch.models.resnet import BottleneckBlock, block_flax_names

#: channels of the features the client sends: 16 planes x expansion 4
FEATURE_CHANNELS = 16 * BottleneckBlock.expansion


class ResNetClientGKT(nn.Module):
    """resnet8_56's role: the stem and ``num_blocks`` stage-1 bottlenecks;
    returns (logits of the auxiliary head, the features ``[B, 64, H,
    W]``)."""

    def __init__(self, num_blocks: int = 2, num_classes: int = 10):
        super().__init__()
        self.stem = nn.Conv2d(3, 16, 3, 1, 1, bias=False)
        self.stem_bn = BatchNorm(16)
        blocks, in_planes = [], 16
        for _ in range(num_blocks):
            blocks.append(BottleneckBlock(in_planes, 16))
            in_planes = FEATURE_CHANNELS
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(in_planes, num_classes)
        self.flax_names = block_flax_names(
            {"stem": "Conv_0", "stem_bn": "BatchNorm_0", "fc": "Dense_0"},
            blocks)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.stem_bn(self.stem(x), train))
        for blk in self.blocks:
            x = blk(x, train)
        return self.fc(x.mean((2, 3))), x


class ResNetServerGKT(nn.Module):
    """resnet56_server's role: the stages over the received features (NCHW,
    64 channels), the global pool and the head."""

    def __init__(self, stage_sizes: Sequence[int] = (6, 6, 6),
                 num_classes: int = 10):
        super().__init__()
        blocks, in_planes = [], FEATURE_CHANNELS
        for stage, n in enumerate(stage_sizes):
            planes = 16 * 2 ** stage
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(BottleneckBlock(in_planes, planes, stride))
                in_planes = planes * BottleneckBlock.expansion
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(in_planes, num_classes)
        self.flax_names = block_flax_names({"fc": "Dense_0"}, blocks)

    def forward(self, features: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = features
        for blk in self.blocks:
            x = blk(x, train)
        return self.fc(x.mean((2, 3)))


def resnet8_56(num_classes: int = 10) -> ResNetClientGKT:
    return ResNetClientGKT(num_blocks=2, num_classes=num_classes)


def resnet56_server(num_classes: int = 10) -> ResNetServerGKT:
    return ResNetServerGKT(stage_sizes=(6, 6, 6), num_classes=num_classes)


# -- the .pth warm start ------------------------------------------------------

def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` file as ``{name: tensor}`` on the CPU: a bare state dict or
    a ``{'state_dict': ...}`` checkpoint wrapper, with DataParallel's
    ``module.`` prefix stripped."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "state_dict" in blob and not any(
            torch.is_tensor(v) for v in blob.values()):
        blob = blob["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k):
            v.detach() for k, v in blob.items() if torch.is_tensor(v)}


def _group_by_kind(state: Dict[str, torch.Tensor]):
    """Queues of the file's tensors by kind, in its order: conv weights
    (rank 4), linear ``(weight, bias or None)`` pairs (rank 2, a bias that
    follows under the same prefix closing the pair) and BatchNorm groups
    of weight, bias, running mean and variance."""
    convs: List[torch.Tensor] = []
    linears: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
    bns: List[Dict[str, torch.Tensor]] = []
    open_bns: Dict[str, Dict[str, torch.Tensor]] = {}
    pending = None  # (prefix, weight) of a linear awaiting its bias
    for key, val in state.items():
        prefix, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        if leaf == "num_batches_tracked":
            continue
        if pending is not None and not (leaf == "bias"
                                        and prefix == pending[0]):
            linears.append((pending[1], None))
            pending = None
        if leaf == "weight" and val.dim() == 4:
            convs.append(val)
        elif leaf == "weight" and val.dim() == 2:
            pending = (prefix, val)
        elif leaf == "bias" and pending is not None:
            linears.append((pending[1], val))
            pending = None
        elif leaf in ("weight", "bias", "running_mean", "running_var"):
            group = open_bns.setdefault(prefix, {})
            group[leaf] = val
            if len(group) == 4:
                bns.append(open_bns.pop(prefix))
        else:
            raise ValueError(f"unrecognized torch tensor {key!r} of shape "
                             f"{tuple(val.shape)}")
    if pending is not None:
        linears.append((pending[1], None))
    if open_bns:
        raise ValueError(f"incomplete BatchNorm groups: {sorted(open_bns)}")
    return convs, linears, bns


def load_reference_client_state(state: Dict[str, torch.Tensor],
                                 model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state dict filled from a torch state dict of the mirrored
    architecture (the reference's resnet_client): conv, linear and
    BatchNorm tensors matched by kind, each kind in the file's order onto
    the model's modules in their registration order, the layouts unchanged
    (both are torch's). Every shape is checked, and a count that differs
    raises."""
    convs, linears, bns = _group_by_kind(state)
    queues = {nn.Conv2d: iter(convs), nn.Linear: iter(linears),
              BatchNorm: iter(bns)}
    out: Dict[str, torch.Tensor] = {}

    def put(name, got, want):
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{name}: torch checkpoint {tuple(got.shape)} "
                             f"against the model's {tuple(want.shape)}")
        out[name] = got.to(want.dtype).clone()

    for mname, m in model.named_modules():
        kind = next((k for k in queues if type(m) is k), None)
        if kind is None:
            continue
        src = next(queues[kind], None)
        if src is None:
            raise ValueError(f"the torch checkpoint has fewer "
                             f"{kind.__name__} layers than the model "
                             f"({mname!r} has none)")
        if kind is nn.Conv2d:
            put(f"{mname}.weight", src, m.weight)
        elif kind is nn.Linear:
            w, b = src
            put(f"{mname}.weight", w, m.weight)
            put(f"{mname}.bias", b if b is not None
                else torch.zeros_like(m.bias), m.bias)
        else:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                put(f"{mname}.{leaf}", src[leaf], getattr(m, leaf))
    for kind, q in queues.items():
        left = sum(1 for _ in q)
        if left:
            raise ValueError(f"{left} torch {kind.__name__} layers unused")
    missing = set(model.state_dict()) - set(out)
    if missing:
        raise ValueError(f"no checkpoint tensor for {sorted(missing)}")
    return out
