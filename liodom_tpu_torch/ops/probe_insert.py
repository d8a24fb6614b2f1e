"""The hash-grid probe: CUDA kernel wrapper + plain version.

Find-or-insert of packed (cell, leaf) codes into the map's slot table, the
rounds of ``liodom_tpu/mapping/grid.py:_probe_insert``.  That function is a
``lax.while_loop`` whose exit test depends on the data, not a TPU kernel; in
PyTorch the test would be one host synchronisation a round, so on CUDA the
rounds run inside one launch of ``csrc/probe_insert.cu``, two phases a round
(:func:`probe_insert_two_phase` models its schedule).

A table slot holds one int64 code (``code1 << 26 | code2`` of the JAX
package's two uint32 words) or :data:`EMPTY`, which lies above every valid
code (< 2^57), so the JAX package's lexicographic-min claim of the two words
is one ``amin`` of the code here.  :func:`probe_insert` dispatches on the
tensors' device: a CUDA tensor launches the kernel, a CPU tensor takes
:func:`probe_insert_plain`.  Both are bit-exact with each other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from liodom_tpu_torch import kernels

EMPTY = (1 << 63) - 1   # empty-slot code: above every valid code (< 2^57)
MAX_PROBES = 64
_K2_BITS = 26           # the JAX package's minor word: code & (2^26 - 1)
_K2_MASK = (1 << _K2_BITS) - 1
_U32 = 0xFFFFFFFF

_SIG = [("liodom_probe_insert", [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int]
         + [ctypes.c_void_p] * 6),
        ("liodom_probe_insert_shape", [ctypes.c_void_p])]


def mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``(a * m) mod 2^32`` of int64 tensors holding uint32 values, as
    uint32 arithmetic wraps: the product is taken on 16-bit halves so
    nothing leaves int64 before the mod."""
    a = a & _U32
    lo = (a & 0xFFFF) * m
    hi = ((a >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def hash_pair(k1: torch.Tensor, k2: torch.Tensor, table_size: int
              ) -> torch.Tensor:
    """Slot hash of a (k1, k2) word pair, the JAX package's uint32 mix
    ``(k1 * 0x9E3779B1) ^ (k2 * 0x85EBCA77)``, ``h ^= h >> 15``, ``h % n``,
    on int64 tensors holding the words' uint32 values (:func:`mul32`)."""
    h = mul32(k1, 0x9E3779B1) ^ mul32(k2, 0x85EBCA77)
    h = h ^ (h >> 15)
    return h % table_size


def hash_code(code: torch.Tensor, table_size: int) -> torch.Tensor:
    """Home slot (int32) of packed codes: :func:`hash_pair` of its words."""
    return hash_pair(code >> _K2_BITS, code & _K2_MASK,
                     table_size).to(torch.int32)


def probe_insert_plain(tab: torch.Tensor, code: torch.Tensor,
                       active: torch.Tensor, with_rounds: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """Find-or-insert of ``code`` (E,) into the table ``tab`` (C,), the
    rounds of the JAX package's ``_probe_insert`` as torch ops.

    Triangular quadratic probing (slot += round); a round gathers every
    unfinished row's slot, matches its code or, on an empty slot, claims it
    by ``amin`` (the smallest code wins, so duplicates converge on one slot
    whatever the order), and steps the rows that neither matched nor won.
    At most :data:`MAX_PROBES` rounds.  Returns ``(tab, slot (E,) int32,
    claimed (E,), failed (E,))``, and the rounds run (() int32) after them
    with ``with_rounds``; a failed row's ``slot`` is the one it would have
    probed next.  One host synchronisation a round (the loop test): the
    CPU's path."""
    n = tab.shape[0]
    ext = torch.cat([tab, tab.new_full((1,), EMPTY)])   # spare row n: dropped
    slot = hash_code(code, n)
    done = ~active
    claimed = torch.zeros_like(active)
    probe = 0
    while probe < MAX_PROBES and bool((~done).any()):
        s = torch.where(done, 0, slot).long()
        g = ext[s]
        match = ~done & (g == code)
        empty = ~done & (g == EMPTY)
        ext.scatter_reduce_(0, torch.where(empty, slot, n).long(), code,
                            "amin")
        won = empty & (ext[s] == code)
        claimed = claimed | won
        done = done | match | won
        slot = torch.where(done, slot, (slot + probe + 1) % n)
        probe += 1
    out = (ext[:n], slot, claimed, active & ~done)
    return out + (_rounds(probe, tab),) if with_rounds else out


def _rounds(r: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), r, dtype=torch.int32, device=like.device)


def probe_insert_two_phase(tab: torch.Tensor, code: torch.Tensor,
                           active: torch.Tensor, with_rounds: bool = False
                           ) -> Tuple[torch.Tensor, ...]:
    """The schedule of ``csrc/probe_insert.cu`` as torch ops, a model held
    against :func:`probe_insert_plain`: two phases a round.  Each row's
    table read is taken one phase early, at the end of the round before
    (the home slots' before round 0): phase 1 settles the rows whose read
    found their code and claims the empty slots (``amin``); phase 2, with
    every claim of the round landed and none of the next begun, reads the
    pending rows' claims back and every unfinished row's next slot
    (``slot + r + 1``) in one go, and a row that did not win steps there
    with that read in hand.  Same contract as :func:`probe_insert_plain`."""
    n = tab.shape[0]
    ext = torch.cat([tab, tab.new_full((1,), EMPTY)])   # spare row n
    slot = hash_code(code, n)
    live = active.clone()
    won = torch.zeros_like(active)
    g = ext[torch.where(live, slot, n).long()]
    match, empty = live & (g == code), live & (g == EMPTY)
    r = 0
    while r < MAX_PROBES and bool(live.any()):
        # 1: match or claim
        live = live & ~match
        pend = live & empty
        ext.scatter_reduce_(0, torch.where(pend, slot, n).long(), code,
                            "amin")
        # 2: the claims read back and the next slots read, together
        nxt = (slot + r + 1) % n
        back = ext[torch.where(pend, slot, n).long()]
        g = ext[torch.where(live, nxt, n).long()]
        w = pend & (back == code)
        won, live = won | w, live & ~w
        slot = torch.where(live, nxt, slot)
        match, empty = live & (g == code), live & (g == EMPTY)
        r += 1
    out = (ext[:n], slot, won, live)
    return out + (_rounds(r, tab),) if with_rounds else out


def probe_shape() -> dict:
    """The probe kernel's launch as the built library reports it (CUDA
    only): blocks of its one cluster, threads a block, rows a thread keeps
    on chip, rows on chip in all."""
    out = (ctypes.c_int * 4)()
    kernels.load("probe_insert", _SIG).liodom_probe_insert_shape(out)
    return {"cluster_blocks": out[0], "threads": out[1],
            "rows_per_thread": out[2], "rows_on_chip": out[3]}


def probe_insert_cuda(tab: torch.Tensor, code: torch.Tensor,
                      active: torch.Tensor, with_rounds: bool = False
                      ) -> Tuple[torch.Tensor, ...]:
    """The probe rounds as one launch of ``csrc/probe_insert.cu`` on CUDA
    tensors; same contract as :func:`probe_insert_plain` (the rounds are
    the kernel's own count).  The input table is left untouched (the kernel
    updates a copy)."""
    if not (tab.is_cuda and code.device == tab.device
            and active.device == tab.device):
        raise ValueError("probe_insert_cuda needs all tensors on one CUDA "
                         "device")
    if (tab.dtype != torch.int64 or code.dtype != torch.int64
            or active.dtype != torch.bool):
        raise TypeError("probe_insert_cuda takes int64 table and codes and a "
                        "bool mask")
    n, e = tab.shape[0], code.shape[0]
    if tab.ndim != 1 or code.ndim != 1 or active.shape != (e,) or n < 1:
        raise ValueError(f"probe_insert_cuda shapes: tab {tuple(tab.shape)}, "
                         f"code {tuple(code.shape)}, "
                         f"active {tuple(active.shape)}")
    if n > 2**31 - 1 - MAX_PROBES:
        raise ValueError(f"table of {n} slots exceeds the kernel's int32 slot")
    code, active = code.contiguous(), active.contiguous()
    out = tab.clone(memory_format=torch.contiguous_format)
    slot = torch.empty(e, dtype=torch.int32, device=tab.device)
    spill = torch.empty(e, dtype=torch.uint8, device=tab.device)
    claimed = torch.empty(e, dtype=torch.bool, device=tab.device)
    failed = torch.empty(e, dtype=torch.bool, device=tab.device)
    # the kernel writes the rounds; with no code it is not launched
    rounds = (torch.empty if e > 0 else torch.zeros)(
        (), dtype=torch.int32, device=tab.device)
    lib = kernels.load("probe_insert", _SIG)
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.liodom_probe_insert(
            out.data_ptr(), n, code.data_ptr(), active.data_ptr(), e,
            MAX_PROBES, slot.data_ptr(), spill.data_ptr(),
            claimed.data_ptr(), failed.data_ptr(), rounds.data_ptr(), stream)
    kernels.check(err, "liodom_probe_insert")
    if e > 0:                       # no codes: the library launches nothing
        probe_insert_cuda.launches += 1
    res = (out, slot, claimed, failed)
    return res + (rounds,) if with_rounds else res


probe_insert_cuda.launches = 0


def probe_insert(tab: torch.Tensor, code: torch.Tensor, active: torch.Tensor,
                 with_rounds: bool = False) -> Tuple[torch.Tensor, ...]:
    """The probe on the tensors' device: the kernel for CUDA tensors, the
    plain rounds for CPU tensors; with ``with_rounds`` the rounds run
    (() int32) come last."""
    if tab.is_cuda:
        return probe_insert_cuda(tab, code, active, with_rounds)
    kernels.require_cpu(tab, "probe_insert")
    return probe_insert_plain(tab, code, active, with_rounds)
