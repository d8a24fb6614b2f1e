"""The benchmark's one door into the system under test, ``liodom_tpu_torch``.

Everything the harness calls of the port goes through here, by the port's
public entry points: the presets and configs, the steps
(``odometry/pipeline``, ``mapping/service``), the warm start
(``runtime/aot.get_or_compile``), the frame traffic
(``runtime/device_io``: ``Stager``, ``fetch_poses``, ``prepare_kernels``,
``prepare_loader``; ``runtime/native``: ``SplitPrefetcher``,
``split_velodyne``), the batched state (``parallel/sharded``) and the
live queue (``runtime/channels``).  The port is imported when a function
here is first called, never when this module is imported.
"""

from __future__ import annotations

import importlib
from typing import Callable, Tuple


def _mod(name: str):
    return importlib.import_module(f"liodom_tpu_torch.{name}")


def configs(config: dict):
    """(LiodomConfig, MapConfig or None) as the configuration file states:
    the named preset, then every value of its ``odometry`` and ``map``
    groups.  Raises on a key the port's configs do not have."""
    presets = _mod("core.presets")
    cfg, mcfg = getattr(presets, config["preset"])(**config["preset_args"])
    cfg = cfg.replace(**config["odometry"])
    mcfg = mcfg.replace(**config["map"]) if config.get("map") else None
    return cfg, mcfg


def init(cfg, mcfg, device, lanes: int = 1):
    """The start state: an ``OdomState`` (a batch of ``lanes`` when more
    than one), with a ``MapState`` for a mapping configuration."""
    if mcfg is not None:
        return _mod("mapping.service").init_combined(cfg, mcfg, device=device)
    if lanes > 1:
        return _mod("parallel.sharded").init_batch_state(cfg, lanes,
                                                         device=device)
    return _mod("odometry.pipeline").init_state(cfg, device=device)


def step_fn(cfg, mcfg, lanes: int = 1) -> Callable:
    """The frame step as the apps call it: ``(state, image, counts) ->
    (state, pose, n_edges)``, ``state`` a pair (odometry, map) for a
    mapping configuration (``combined_image_step``, the local map
    refreshed every frame), a batch for ``lanes`` > 1
    (``batch_image_step``)."""
    if mcfg is not None:
        svc = _mod("mapping.service")

        def combined(state, x, c):
            o, m, pose, ne = svc.combined_image_step(state[0], state[1], x, c,
                                                     cfg, mcfg, step=0,
                                                     local_map_every=1)
            return (o, m), pose, ne
        return combined
    pipe = _mod("odometry.pipeline")
    if lanes > 1:
        return lambda s, x, c: pipe.batch_image_step(s, x, c, cfg)
    return lambda s, x, c: pipe.image_step(s, x, c, cfg)


def captured(name: str, fn: Callable, example: tuple, extra: str,
             kernels) -> Callable:
    """``fn`` captured as a CUDA graph by ``runtime/aot.get_or_compile``
    (on the CPU, ``fn`` after a warm call)."""
    return _mod("runtime.aot").get_or_compile(name, fn, example, extra=extra,
                                              kernel_names=kernels)


def path_kernels(mapping: bool):
    return _mod("runtime.device_io").path_kernels(mapping)


def prepare(mapping: bool, device) -> dict:
    """Build (when missing) and load the kernels and the native loader."""
    dio = _mod("runtime.device_io")
    out = dict(dio.prepare_loader())
    out.update(dio.prepare_kernels(dio.path_kernels(mapping), device))
    return out


def stager(shape, device, slots: int):
    return _mod("runtime.device_io").Stager(shape, device, slots=slots)


def staging_slots(chunk: int, due_every, ahead: bool) -> int:
    return _mod("runtime.device_io").staging_slots(chunk, due_every, ahead)


def fetch_poses(pending):
    return _mod("runtime.device_io").fetch_poses(pending)


def prefetcher(paths, cfg, threads: int):
    return _mod("runtime.native").SplitPrefetcher(
        paths, cfg.scan_lines, cfg.ring_width, cfg.min_range, cfg.max_range,
        n_threads=threads)


def split(points, cfg):
    """The loader's ring split of one (N, 3) spin: (image, counts, points
    dropped past the ring width)."""
    return _mod("runtime.native").split_velodyne(
        points, cfg.scan_lines, cfg.ring_width, cfg.min_range, cfg.max_range)


def channel(maxsize: int):
    return _mod("runtime.channels").Channel(maxsize=maxsize)


def channel_errors() -> Tuple[type, type]:
    ch = _mod("runtime.channels")
    return ch.Closed, TimeoutError
