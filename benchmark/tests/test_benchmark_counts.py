"""The kernels' roofline counts on small shapes: every input byte read once
and every output byte written once, from the frame's own inputs and never
from a kernel's tiles, flags or rounds."""

import ast
from pathlib import Path

import numpy as np
import pytest

from benchmark import roofline, spec

COUNTS = Path(spec.HERE) / "counts"


def frame(**kw):
    d = {"counts": np.array([100, 0, 20, 600]), "rings": 4, "ring_width": 512,
         "regions": 2, "picks": 3, "edge_slots": 24, "edges": 10,
         "window_slots": 72, "window_points": 30, "k": 5, "received": 0,
         "received_slots": 0}
    d.update(kw)
    return d


def test_smoothness_reads_each_point_once():
    b, ops = spec.count("smoothness").count(frame())
    # points below the (width-clamped) counts, the counts, the plane
    assert b == (100 + 0 + 20 + 512) * 12 + 4 * 4 + 4 * 512 * 4
    assert ops == (90 + 0 + 10 + 502) * 41


def test_select_lower_bound():
    b, ops = spec.count("select").count(frame())
    active = [100, 20, 512]              # rings with >= 2 * 2 + 10 points
    cols = sum(c - 10 for c in active)
    assert b == 4 * 4 + cols * 4 + 10 * 12 + 24 * 13
    assert ops == cols


def test_knn_bytes_once_in_once_out():
    b, ops = spec.count("knn_coords").count(frame(received=7,
                                                   received_slots=16))
    assert ops == 0
    assert b == 24 + 10 * 12 + (72 + 16) + (30 + 7) * 12 + 24 * 5 * 16
    lanes = {"lanes": [frame(), frame(edges=3)]}
    bb, _ = spec.count("knn_coords_batched").count(lanes)
    assert bb == (spec.count("knn_coords").count(frame())[0]
                  + spec.count("knn_coords").count(frame(edges=3))[0])


def test_map_counts():
    f = frame(occupied_before=100, occupied_after=130, hits=50,
              map_slots=1024, local_slots=64)
    b, _ = spec.count("local_map_compact").count(f)
    assert b == 1024 + 130 * 12 + 50 * 12 + 64 * 13 + 4
    b, _ = spec.count("probe_insert").count(f)
    assert b == 24 + 10 * 16 + 24 * 6 + 30 * 8
    big = dict(f, hits=100)
    b2, _ = spec.count("local_map_compact").count(big)
    assert b2 == 1024 + 130 * 12 + 64 * 12 + 64 * 13 + 4


def test_least_time():
    assert roofline.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 67e12) == pytest.approx(1.0)


@pytest.mark.parametrize("path", sorted(COUNTS.glob("*.py")),
                         ids=lambda p: p.stem)
def test_counts_read_no_kernel_layout(path):
    """A count names its kernel and reads the frame's inputs only: it
    imports nothing of the port and no key or name of it speaks of tiles,
    flags, rounds or the kernel's sort."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    names = set()
    for node in ast.walk(tree):
        if id(node) in docs:
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names] + [getattr(node, "module",
                                                           "") or ""]
            assert not any(m.startswith("liodom") for m in mods)
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            names.add(node.value)
        if isinstance(node, ast.Name):
            names.add(node.id)
        if isinstance(node, ast.Attribute):
            names.add(node.attr)
    code = " ".join(n.lower() for n in names)
    for word in ("tile", "flag", "round", "qperm", "perm", "cluster"):
        assert word not in code, (path.name, word)
    mod = spec.count(path.stem)
    assert isinstance(mod.KERNEL, str) and callable(mod.count)
