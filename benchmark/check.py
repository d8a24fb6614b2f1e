"""Whether what the timed path produced is correct: the plain reference
(``benchmark/reference``) holds the frames a run kept, and the state it
started from, to the limits of the cell (``benchmark/limits``).

Odometry is a filter: each pose rests on the window of the frames before
it, and two float32 programs drift apart over thousands of frames by
rounding alone.  So a kept frame is judged from the program's own state
before it (its window, its last two poses, the local map it received): the
reference re-splits the frame's spin, selects its edges and solves its
pose, and the stage that carries the state on (the window's push, the map
update and the local map handed on) is checked by itself, by the
reference's push and update of the program's state at the program's pose.
The start, the one state no frame made, is checked against the
reference's empty state, and the first ``start_frames`` frames are always
kept besides the ones drawn from the seed.

The numbers compared (each beside its limit in the run's output):

* ``init_gap``: elements of the program's first state that differ from
  the empty state (exact: 0);
* ``split_gap``: points of the program's ring image, and ring counts, that
  differ from the reference's split (exact: 0);
* ``edge_gap``: edges a frame, program against reference (exact: 0);
* ``pose_gap_m``, ``rot_gap_rad``: the median over the kept frames of the
  translation and rotation gap of a frame's pose (the widest gap, from the
  frames where an LM step whose cost change sits at rounding is kept by
  one side only, swings from seed to seed; it is printed as
  ``pose_gap_max_m`` and ``rot_gap_max_rad``, not compared);
* ``pose_frames_over``: the kept frames whose translation gap passes
  ``FRAME_LEVEL_M`` or whose rotation gap passes ``FRAME_LEVEL_RAD``, so
  that a fault on fewer than half of the frames (some lanes of a batch,
  some frames of a drive) fails the run, which the median would let
  pass; the limit allows the few frames where an LM step at rounding is
  kept by one side only;
* ``window_gap_m``: the largest gap of the window after the push;
* with the map, ``occupied_gap`` (leaves), ``received_count_gap``
  (rows of the local map handed on) and ``received_gap_m`` (the median
  distance between the two local maps' rows of one leaf); a point that
  lies on a leaf's boundary can fall in the next leaf on one side only,
  since the two sides transform in another order, so the two counts are
  held to a limit set from readings, not to 0;
* ``lossy_frames``: frames the loader, the map or the local map cut
  (exact: 0).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import mapping as RM
from benchmark.reference import odometry as RO
from benchmark.reference.linalg import Pose, angle_between, transform

# a kept frame whose pose lies further than this from the reference's
# counts in ``pose_frames_over`` (set from readings: PERF.md)
FRAME_LEVEL_M = 2.5e-4
FRAME_LEVEL_RAD = 2.5e-5

@dataclass
class Sample:
    """A frame of the window kept for the check: lane ``lane``'s frame
    ``index`` (0 = its first), the program's state before and after it,
    its pose (q, t), its edge count and the ring image it was given."""
    lane: int
    index: int
    before: Any
    after: Any
    q: torch.Tensor
    t: torch.Tensor
    n_edges: torch.Tensor
    image: Optional[tuple] = None


class Reservoir:
    """A uniform sample of ``size`` of the window's frames, drawn from the
    seed as they come (algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
        self.seen = 0
        self.kept: List[Optional[Sample]] = []

    def slot(self) -> Optional[int]:
        """Where the next frame goes, or None when it is not kept."""
        n = self.seen
        self.seen += 1
        if n < self.size:
            self.kept.append(None)
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.size else None

    def put(self, slot: int, sample: Sample) -> None:
        self.kept[slot] = sample

    def samples(self) -> List[Sample]:
        return [s for s in self.kept if s is not None]


def _lane(x: torch.Tensor, lane: Optional[int]) -> torch.Tensor:
    return x if lane is None else x[lane]


def ref_state(odom, lane: Optional[int]) -> RO.State:
    """The reference's view of the program's odometry state (one lane of a
    batch)."""
    w = odom.window
    return RO.State(
        RO.Window(_lane(w.xyz, lane), _lane(w.valid, lane),
                  int(_lane(w.next_slot, lane)), int(_lane(w.nframes, lane))),
        Pose(_lane(odom.odom.q, lane), _lane(odom.odom.t, lane)),
        Pose(_lane(odom.prev_odom.q, lane), _lane(odom.prev_odom.t, lane)),
        _lane(odom.received_xyz, lane), _lane(odom.received_valid, lane))


def _window_gap(a: RO.Window, b: RO.Window) -> float:
    if (a.next_slot != b.next_slot or a.nframes != b.nframes
            or not torch.equal(a.valid, b.valid)):
        return math.inf
    return float((a.xyz - b.xyz).abs().max())


class Judge:
    """Computes the numbers of one run (``subject`` None: the program's;
    ``"tf32"``: the control, the reference at TF32 in its place)."""

    def __init__(self, prm: RO.Params, mprm: Optional[RM.MapParams],
                 local_cap: int, subject: Optional[str] = None):
        self.prm, self.mprm, self.local_cap = prm, mprm, local_cap
        self.subject = subject
        self.gaps: Dict[str, float] = {}
        self.poses: List[tuple] = []

    def worst(self, name: str, value: float) -> None:
        self.gaps[name] = max(self.gaps.get(name, 0.0), float(value))

    def numbers(self) -> Dict[str, float]:
        """The run's numbers: the worst of each, the pose gaps' medians
        and widest."""
        out = dict(self.gaps)
        if self.poses:
            t, r = np.asarray(self.poses).T
            out.update(pose_gap_m=float(np.median(t)),
                       rot_gap_rad=float(np.median(r)),
                       pose_gap_max_m=float(t.max()),
                       rot_gap_max_rad=float(r.max()),
                       pose_frames_over=float(np.sum(
                           (t > FRAME_LEVEL_M) | (r > FRAME_LEVEL_RAD))))
        return out

    def frame_gaps(self) -> List[tuple]:
        """(translation, rotation) gap of each kept frame, in the order
        judged."""
        return list(self.poses)

    def init(self, state) -> None:
        """The program's state before frame 0 against the empty state:
        zero windows, no frames, identity poses, nothing received, an
        empty map."""
        odom, mstate = (state if self.mprm is None else state[0]), (
            None if self.mprm is None else state[1])
        w = odom.window
        bad = int(w.xyz.count_nonzero()) + int(w.valid.count_nonzero())
        bad += int(w.next_slot.count_nonzero()) + int(
            w.nframes.count_nonzero())
        for p in (odom.odom, odom.prev_odom):
            ident = torch.zeros_like(p.q)
            ident[..., 0] = 1.0
            bad += int((p.q != ident).sum()) + int(p.t.count_nonzero())
        bad += int(odom.received_valid.count_nonzero())
        if mstate is not None:
            bad += int(mstate.valid.count_nonzero()) + int(
                mstate.overflow.count_nonzero())
        self.worst("init_gap", bad)

    def frame(self, sample: Sample, raw: torch.Tensor,
              lane: Optional[int]) -> None:
        """Hold one sampled frame to the reference."""
        prm = self.prm
        odom, mstate = (sample.before if self.mprm is None
                        else sample.before[0]), None
        if self.mprm is not None:
            mstate = sample.before[1]
        state = ref_state(odom, lane)
        ex, ev, counts, dropped = RO.frame_edges(raw, prm)
        self.worst("lossy_frames", 1 if dropped else 0)
        ref_pose = RO.solve(state, ex, ev, prm, "float32")
        if self.subject is None:
            pose = Pose(sample.q, sample.t)
            n_edges = int(sample.n_edges)
            after = sample.after if self.mprm is None else sample.after[0]
            got_window = ref_state(after, lane).window
            split = 0
            if sample.image is not None:
                x, c = sample.image
                img, _, _ = RO.features.split_velodyne(
                    raw.cpu().numpy(), prm.ring_width, prm.min_range,
                    prm.max_range)
                split = int((c.cpu().numpy() != counts).sum()) + int(
                    (x.cpu().numpy() != img).any(-1).sum())
            self.worst("split_gap", split)
        else:
            pose = RO.solve(state, ex, ev, prm, self.subject)
            n_edges = int(ev.sum())
            got_window = RO.push(state.window,
                                 transform(pose, ex, self.subject), ev)
            self.worst("split_gap", 0)
        self.worst("edge_gap", abs(n_edges - int(ev.sum())))
        self.poses.append((float(torch.linalg.norm(
            pose.t.double() - ref_pose.t.double())),
            angle_between(pose.q, ref_pose.q)))
        want = RO.push(state.window, transform(pose, ex, "float32"), ev)
        self.worst("window_gap_m", _window_gap(want, got_window))
        if self.mprm is not None:
            self._map(sample, mstate, ex, ev, pose, lane)

    def _map(self, sample: Sample, mstate, ex, ev, pose: Pose, lane) -> None:
        mp = self.mprm
        rows = mstate.xyz[mstate.valid]
        want = RM.update(rows, ex, ev, pose, mp, "float32")
        want_local = RM.local_map(want, pose.t, mp)
        if self.subject is None:
            o_after, m_after = sample.after
            got_count = int(m_after.valid.sum())
            got_local, _ = RM.received_rows(_lane(o_after.received_xyz, lane),
                                            _lane(o_after.received_valid,
                                                  lane))
            lossy = int(m_after.overflow) > 0 or len(want_local) > \
                self.local_cap
        else:
            got = RM.update(rows, ex, ev, pose, mp, self.subject)
            got_count = len(got)
            got_local = RM.local_map(got, pose.t, mp)
            lossy = False
        self.worst("lossy_frames", int(lossy))
        self.worst("occupied_gap", abs(got_count - len(want)))
        self.worst("received_count_gap", abs(len(got_local) - len(want_local)))
        self.worst("received_gap_m", RM.set_gap(got_local, want_local, mp))


def verdict(gaps: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit, in the limits' order."""
    return {k: {"value": gaps.get(k, 0.0), "limit": v}
            for k, v in limits.items()}


def correct(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every number within its limit (an exact one equal to 0)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
