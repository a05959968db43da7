"""Reference-tree schedules for LSVC-style GOP coding: a copy of the pure-Python
fastvideocodec_tpu/gop/graph.py, so that the port imports nothing of the JAX package.

Host-side, static per GOP size.
Mirrors reference generate_graph / graph_from_batch / refidx_from_graph
(models.py:683-728, 923-949): frame ids are 1-based P-frame indices, parent
0 is the I-frame. Layers are truncated to the actual number of P-frames so
each tree level is a static batched slice.
"""

from __future__ import annotations

from dataclasses import dataclass


def generate_graph(graph_type: str = "default"):
    if graph_type == "default":  # chain
        g = {k: [k + 1] for k in range(30)}
        layers = [[i + 1] for i in range(30)]
        parents = {i + 1: i for i in range(30)}
    elif graph_type == "onehop":
        g = {0: [i + 1 for i in range(14)]}
        layers = [[i + 1 for i in range(14)]]
        parents = {i + 1: 0 for i in range(14)}
    elif graph_type == "2layers":
        g = {0: [1, 2]}
        layers = [[1, 2]]
        parents = {1: 0, 2: 0}
    elif graph_type == "3layers":
        g = {0: [1, 4], 1: [2, 3], 4: [5, 6]}
        layers = [[1, 4], [2, 3, 5, 6]]
        parents = {1: 0, 4: 0, 2: 1, 3: 1, 5: 4, 6: 4}
    elif graph_type == "4layers":
        g = {0: [1, 8], 1: [2, 5], 8: [9, 12], 2: [3, 4], 5: [6, 7], 9: [10, 11], 12: [13, 14]}
        layers = [[1, 8], [2, 5, 9, 12], [3, 4, 6, 7, 10, 11, 13, 14]]
        parents = {1: 0, 8: 0, 2: 1, 5: 1, 9: 8, 12: 8, 3: 2, 4: 2, 6: 5, 7: 5,
                   10: 9, 11: 9, 13: 12, 14: 12}
    elif graph_type == "5layers":
        g = {0: [1, 16], 1: [2, 9], 16: [17, 24], 2: [3, 6], 9: [10, 13],
             17: [18, 21], 24: [25, 28], 3: [4, 5], 6: [7, 8], 10: [11, 12],
             13: [14, 15], 18: [19, 20], 21: [22, 23], 25: [26, 27], 28: [29, 30]}
        layers = [[1, 16], [2, 9, 17, 24], [3, 6, 10, 13, 18, 21, 25, 28],
                  [4, 5, 7, 8, 11, 12, 14, 15, 19, 20, 22, 23, 26, 27, 29, 30]]
        parents = {1: 0, 16: 0, 2: 1, 9: 1, 17: 16, 24: 16, 3: 2, 6: 2, 10: 9,
                   13: 9, 18: 17, 21: 17, 25: 24, 28: 24, 4: 3, 5: 3, 7: 6, 8: 6,
                   11: 10, 12: 10, 14: 13, 15: 13, 19: 18, 20: 18, 22: 21, 23: 21,
                   26: 25, 27: 25, 29: 28, 30: 28}
    else:
        raise ValueError(f"Undefined graph type: {graph_type}")
    return g, layers, parents


def graph_from_batch(bs: int, is_linear: bool = False, is_onehop: bool = False):
    """Pick the graph for bs P-frames (reference models.py:923-940)."""
    if is_linear:
        return generate_graph("default")
    if is_onehop:
        return generate_graph("onehop")
    if bs <= 2:
        return generate_graph("2layers")
    if bs <= 6:
        return generate_graph("3layers")
    if bs <= 14:
        return generate_graph("4layers")
    if bs <= 30:
        return generate_graph("5layers")
    raise ValueError(f"GOP size not supported: {bs}")


def refidx_from_graph(g: dict, bs: int) -> list[int]:
    """ref_index[i] = frame index (0 = I-frame) whose RAW frame is the flow
    reference for P-frame i+1 (reference models.py:942-949)."""
    ref_index = [-1] * bs
    for start in g:
        if start > bs:
            continue
        for k in g[start]:
            if k > bs:
                continue
            ref_index[k - 1] = start
    return ref_index


@dataclass(frozen=True)
class TreeSchedule:
    """Static, truncated tree schedule for a given number of P-frames.

    layers: tuple of tuples of P-frame ids (1-based) actually present;
    parents: parent id per frame id (0 = I-frame);
    ref_index: flow reference frame per P-frame (0-based into the GOP incl.
    I-frame).
    """

    bs: int
    layers: tuple
    parents: dict
    ref_index: tuple

    @property
    def depth(self) -> int:
        return len(self.layers)


def tree_schedule(bs: int, is_linear: bool = False, is_onehop: bool = False) -> TreeSchedule:
    g, layers, parents = graph_from_batch(bs, is_linear, is_onehop)
    trunc = []
    for layer in layers:
        ids = tuple(t for t in layer if t <= bs)
        if ids:
            trunc.append(ids)
    ref_index = tuple(refidx_from_graph(g, bs))
    return TreeSchedule(bs=bs, layers=tuple(trunc), parents=parents, ref_index=ref_index)
