"""Closed-loop replay of long drives over new ground, as ``run_kitti --aot
--mapping`` replays a KITTI sequence.

Set-up builds the seed's drive (``benchmark/streamworld.py``: a
``StreamWorld`` route of ``drive_frames`` frames), renders it on the card a
few frames at a time and writes each spin's returns as a KITTI ``.bin``
file (x, y, z, intensity float32) into a directory of ``TMPDIR``.  The
window is ``loops/replay``'s: the drive's paths through the port's
``SplitPrefetcher``, the ``Stager``, ``combined_image_step`` captured by
``runtime/aot`` with the local map refreshed every frame, poses fetched
every ``fetch_every`` frames; drives are replayed back to back, each from
an empty state and map.  The check renders a kept frame again
(``Drive.spin``).

With ``--trace 1`` the program's span recorder (``runtime/tracer``) is
armed before the step is captured and disarmed after the window; its
record goes back in ``Result.extra["program"]`` for the readers of
``benchmark/program.py``.  A program without the recorder leaves it out.
"""

from __future__ import annotations

import importlib
import math
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from benchmark import port, streamworld
from benchmark.loops import replay
from benchmark.loops.common import Context, Result, now, sync

WRITERS = 4                  # threads writing the drive's files
BYTES_A_RETURN = 16          # x, y, z, intensity float32


def _write(points: np.ndarray, path: Path) -> int:
    rec = np.zeros((len(points), 4), np.float32)
    rec[:, :3] = points
    rec.tofile(path)
    return rec.nbytes


def write_drive(drive: streamworld.Drive, directory: Path) -> tuple:
    """Render the drive and write its frames' ``.bin`` files in frame order:
    (their paths, render seconds, write seconds that did not overlap the
    render, bytes written)."""
    n = len(drive)
    paths = [directory / f"{i:06d}.bin" for i in range(n)]
    render_s = write_s = 0.0
    written = 0
    with ThreadPoolExecutor(WRITERS) as pool:
        pending = []
        for f0 in range(0, n, streamworld.FRAME_CHUNK):
            t0 = now()
            spins = drive.spins(f0, min(streamworld.FRAME_CHUNK, n - f0))
            host = [s.cpu().numpy() for s in spins]
            render_s += now() - t0
            pending += [pool.submit(_write, h, paths[f0 + k])
                        for k, h in enumerate(host)]
        t0 = now()
        written = sum(p.result() for p in pending)
        write_s = now() - t0
    return [str(p) for p in paths], render_s, write_s, written


def _recorder():
    """The port's span recorder, or None for a program without one."""
    try:
        tr = importlib.import_module("liodom_tpu_torch.runtime.tracer")
    except ImportError:
        return None
    return tr if hasattr(tr, "arm") and hasattr(tr, "snapshot") else None


def run(ctx: Context) -> Result:
    dev = ctx.device
    t_in = now()
    drive = streamworld.Drive(ctx.seed, ctx.config, dev)
    phases = {"import_s": t_in - ctx.t_process, "world_s": now() - t_in}
    tmp = Path(tempfile.mkdtemp(prefix="drive-",
                                dir=os.environ.get("TMPDIR")))
    try:
        free = shutil.disk_usage(tmp).free
        need = len(drive) * 64 * drive.width * BYTES_A_RETURN
        if free < need:
            raise RuntimeError(f"the drive's files need up to {need} B, "
                               f"{tmp} has {free} B free")
        t_in = now()
        paths, render_s, write_s, written = write_drive(drive, tmp)
        sync(dev)
        phases.update(render_s=render_s, write_s=write_s,
                      files_s=now() - t_in, drive_bytes=written)
        laps = max(1, math.ceil(ctx.seconds * replay.LIST_RATE / len(paths)))
        ctx.extra_setup = port.prepare(ctx.mapping, dev)
        ctx.extra_setup.update(phases)
        rec = _recorder() if ctx.tracer.enabled else None
        if rec is not None:
            rec.arm(dev)
        try:
            res = replay._window(ctx, drive, [], paths * laps)
        finally:
            if rec is not None:
                rec.disarm()
        if rec is not None:
            res.extra["program"] = rec.snapshot()
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
