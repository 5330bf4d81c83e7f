"""The mma.sync probe is a card measurement: without a card it raises
rather than report a CPU number."""

import pytest
import torch

from fedml_tpu_torch.experiments import mma_peak


def test_mma_peak_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        mma_peak.main([])
