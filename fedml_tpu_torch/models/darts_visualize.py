"""Genotype visualization, the role of the reference's graphviz plotter; the
counterpart of ``fedml_tpu/models/darts_visualize.py``.

Reference (fedml_api/model/cv/darts/visualize.py:6-39): builds a Digraph
with c_{k-2}/c_{k-1} input nodes, one node per intermediate step, edges
labelled by primitive, all steps feeding c_{k}; rendered to PDF via the
graphviz binary. Here, with no graphviz, :func:`genotype_to_dot`
emits the same graph as portable DOT source (renderable anywhere with
``dot -Tpdf``), :func:`plot` writes ``<name>.dot`` files, and
:func:`format_genotype` gives a terminal-friendly summary for round logs
(the FedNAS aggregator logs the genotype every round,
FedNASAggregator.py:173).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

Edge = Tuple[str, int]  # (primitive, predecessor index)

_NODE_STYLE = ('style=filled shape=rect align=center fontsize=20 '
               'height=0.5 width=0.5 penwidth=2 fontname=times')


def _src_name(j: int) -> str:
    if j == 0:
        return "c_{k-2}"
    if j == 1:
        return "c_{k-1}"
    return str(j - 2)


def genotype_to_dot(gene: Sequence[Edge], name: str = "cell") -> str:
    """DOT source for one cell (normal or reduce): 2 edges per step."""
    if len(gene) % 2:
        raise ValueError(f"genotype has odd edge count {len(gene)}")
    steps = len(gene) // 2
    lines: List[str] = [
        f'digraph "{name}" {{',
        "  rankdir=LR;",
        f"  node [{_NODE_STYLE}];",
        '  edge [fontsize=20 fontname=times];',
        '  "c_{k-2}" [fillcolor=darkseagreen2];',
        '  "c_{k-1}" [fillcolor=darkseagreen2];',
    ]
    for i in range(steps):
        lines.append(f'  "{i}" [fillcolor=lightblue];')
    lines.append('  "c_{k}" [fillcolor=palegoldenrod];')
    for i in range(steps):
        for op, j in gene[2 * i:2 * i + 2]:
            lines.append(f'  "{_src_name(j)}" -> "{i}" [label="{op}"];')
    for i in range(steps):
        lines.append(f'  "{i}" -> "c_{{k}}";')
    lines.append("}")
    return "\n".join(lines) + "\n"


def plot(genotype, directory: str, prefix: str = "") -> List[str]:
    """Write ``<prefix>normal.dot`` / ``<prefix>reduction.dot`` (the two
    files the reference renders, visualize.py:55-56). Returns the paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for cell_name, gene in (("normal", genotype.normal),
                            ("reduction", genotype.reduce)):
        path = os.path.join(directory, f"{prefix}{cell_name}.dot")
        with open(path, "w") as fh:
            fh.write(genotype_to_dot(gene, name=cell_name))
        paths.append(path)
    return paths


def format_genotype(genotype) -> str:
    """One-line-per-node text rendering for round logs."""
    out = []
    for cell_name, gene, concat in (
            ("normal", genotype.normal, genotype.normal_concat),
            ("reduce", genotype.reduce, genotype.reduce_concat)):
        out.append(f"{cell_name} (concat {list(concat)}):")
        for i in range(len(gene) // 2):
            edges = ", ".join(f"{op}({_src_name(j)})"
                              for op, j in gene[2 * i:2 * i + 2])
            out.append(f"  node {i} <- {edges}")
    return "\n".join(out)
