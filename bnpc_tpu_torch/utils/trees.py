"""Tree-format utilities: newick -> graphviz, .gv parsing, cell collapsing
(counterpart of bnpc_tpu/utils/trees.py).

Behavioral counterpart of libs/utils.py:295-424 (standalone helpers for
visualizing simulation trees; not on the inference path), re-implemented
from the format specs rather than the reference's regex-replacement loops:

  * newick input is handled by a recursive-descent parser over a real token
    stream (the reference repeatedly regex-collapses innermost ``(a:d,b:d)``
    pairs, which only accepts binary trees with ``0.x``-style distances;
    the parser accepts any float distance and nests of any depth, and
    reproduces the reference's internal-node numbering for binary trees);
  * .gv input is parsed statement-by-statement on the ``->`` arrow structure
    instead of three regexes per line.

Output formats (DOT header/label strings) match the reference's artifacts.
"""

from __future__ import annotations

import os
import re

import numpy as np

DOT_HEADER = (
    "digraph G {\n"
    'node [width=0.75 fillcolor="#a6cee3", style=filled, fontcolor=black, '
    'shape=circle, fontsize=20, fontname="arial", fixedsize=True];\n'
)

DOT_CELLS = (
    'node [width=0.5, fillcolor="#e8bdc9", fontcolor=black, '
    'style=filled, shape=square, fontsize=8, fontname="arial", '
    "fixedsize=True];\n"
)


def write_file(path, content, append=False):
    mode = "a" if append and os.path.exists(path) else "w"
    with open(path, mode) as fh:
        fh.write(str(content))


# ---------------------------------------------------------------------------
# Newick
# ---------------------------------------------------------------------------


class _NewickNode:
    __slots__ = ("children", "leaf", "dist", "pos", "round", "node_id")

    def __init__(self, pos):
        self.children = []      # [(child: _NewickNode, dist: float)]
        self.leaf = None        # leaf index, or None for internal nodes
        self.dist = 0.0
        self.pos = pos          # offset of this node's start in the text
        self.round = 0          # collapse round (leaf = 0)
        self.node_id = None


def _parse_newick(text: str, leaf_ids: dict[str, int]) -> _NewickNode:
    """Recursive-descent parse of a newick subtree expression."""
    i = 0

    def parse_node():
        nonlocal i
        node = _NewickNode(i)
        if text[i] == "(":
            i += 1
            while True:
                child = parse_node()
                dist = 0.0
                if i < len(text) and text[i] == ":":
                    i += 1
                    j = i
                    while j < len(text) and (text[j].isdigit()
                                             or text[j] in ".eE+-"):
                        j += 1
                    dist = float(text[i:j])
                    i = j
                node.children.append((child, dist))
                if i < len(text) and text[i] == ",":
                    i += 1
                    continue
                break
            if i < len(text) and text[i] == ")":
                i += 1
        else:
            j = i
            while j < len(text) and text[j] not in "():,;":
                j += 1
            node.leaf = leaf_ids[text[i:j].strip()]
            i = j
        return node

    root = parse_node()
    return root


def edges_from_newick(data: str):
    """Parse newick into (edges, cell names).

    Matches the reference contract (libs/utils.py:308-328): leaves named
    ``<prefix>cell<no>`` are indexed by sorted name; internal nodes are
    numbered from ``len(cells)`` upward in the order the reference's
    innermost-pair collapse would visit them (by collapse round, then by
    text position), and each internal node contributes the edges to its
    children in child order.
    """
    cells = sorted(set(re.findall(r"\w+cell\d*", data)))
    leaf_ids = {name: i for i, name in enumerate(cells)}
    root = _parse_newick(data.strip().rstrip(";"), leaf_ids)

    internal = []

    def annotate(node):
        if node.leaf is not None:
            node.round = 0
            return
        for child, _ in node.children:
            annotate(child)
        node.round = 1 + max(c.round for c, _ in node.children)
        internal.append(node)

    annotate(root)
    internal.sort(key=lambda nd: (nd.round, nd.pos))

    next_id = len(cells)
    edges = []
    for node in internal:
        node.node_id = next_id
        next_id += 1
    for node in internal:
        for child, dist in node.children:
            child_id = child.leaf if child.leaf is not None else child.node_id
            edges.append((node.node_id, child_id, dist))
    return edges, cells


def newick_to_gv(in_file, out_file=""):
    """Convert a newick tree file to graphviz (libs/utils.py:295-305)."""
    with open(in_file) as fh:
        tree = fh.read()
    edges, cells = edges_from_newick(tree)
    gv_tree = edges_to_gv(edges, cells)
    if out_file:
        write_file(out_file, gv_tree)
        return None
    return gv_tree


# ---------------------------------------------------------------------------
# Graphviz mutation trees
# ---------------------------------------------------------------------------


def edges_from_gv(data: str):
    """Parse a .gv mutation tree into mutation edges + cell attachments.

    Contract (libs/utils.py:331-365): statements between the header and the
    closing brace are either ``A -> B`` edges (mutation ids are 1-based in
    the file, returned 0-based; ``s``-prefixed nodes are cells) or bare
    node statements.
    """
    mut_edges: list[tuple[int, int]] = []
    muts: set[int] = set()
    cell_edges: list[tuple[int, str]] = []
    cells: list[str] = []

    statements = data.split(";\n")[1:-1]
    for stmt in statements:
        stmt = stmt.strip()
        if "->" in stmt:
            left, _, right = stmt.partition("->")
            src = left.strip().split()[-1]
            dst = right.strip().split()[0] if right.strip() else ""
            dst = dst.rstrip(";")
            if not src.isdigit():
                continue
            src_id = int(src) - 1
            if dst.startswith("s"):
                cell_edges.append((src_id, dst))
                cells.append(dst)
            elif dst.isdigit():
                dst_id = int(dst) - 1
                if src_id != -1 and dst_id != -1:
                    mut_edges.append((src_id, dst_id))
                muts.update((src_id, dst_id))
        else:
            tail = stmt.split()[-1].rstrip(";") if stmt.split() else ""
            if tail.isdigit():
                muts.add(int(tail) - 1)
    return mut_edges, muts, cell_edges, cells


def edges_to_gv(edges, cells) -> str:
    """Render an edge list as graphviz with length-scaled labels
    (artifact format of libs/utils.py:368-384: edge labels are runs of
    spaces sized proportionally to branch length)."""
    lengths = np.asarray([dist for _, _, dist in edges], dtype=float)
    scale = lengths.max() if lengths.size and lengths.max() > 0 else 1.0
    widths = np.ceil(lengths / scale * 100).astype(int)

    lines = [DOT_HEADER]
    for (src, dst, _), width in zip(edges, widths):
        name = cells[dst] if 0 <= dst < len(cells) else dst
        lines.append(f'{src} -> {name} [label="{" " * width}"];\n')
    lines.append("}")
    return "".join(lines)


def collapse_cells_on_tree(data_folder, out_file=""):
    """Collapse per-cell leaves into per-attachment summary nodes
    (artifact format of libs/utils.py:387-424)."""
    with open(os.path.join(data_folder, "tree.gv")) as fh:
        tree_str = fh.read()
    mut_edges, _, cell_edges, _ = edges_from_gv(tree_str)

    grouped: dict[int, list] = {}
    for mut_from, cell_to in cell_edges:
        grouped.setdefault(mut_from, []).append(cell_to)

    parts = [DOT_HEADER]
    parts += [f"{src} -> {dst};\n" for src, dst in mut_edges]
    parts.append(DOT_CELLS)
    for i, (mut_from, cells_to) in enumerate(grouped.items()):
        size = 0.5 + len(cells_to)
        parts.append(f'{mut_from} -> s{i} [label="{size}", size={size}];\n')
    parts.append("}")

    if not out_file:
        out_file = os.path.join(data_folder, "tree_collapsed.gv")
    write_file(out_file, "".join(parts))

    try:
        from graphviz import render

        render("dot", "png", out_file)
    except Exception:
        # graphviz or the dot binary may be missing/broken; the .gv file is
        # the contract, the .png is best-effort (the reference's gv_to_png
        # has the same failure mode, libs/dpmmIO.py:290-303).
        pass
    return out_file
