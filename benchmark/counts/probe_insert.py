"""The map's find-or-insert (``csrc/probe_insert.cu``): the bytes one
launch's inputs need.

For each edge slot it reads the active mask, and for each live edge its
packed (cell, leaf) code, at least one table slot (8 bytes), and writes
its slot (4 bytes) and its two flags; each new leaf is one 8-byte claim.
The table's copy, a separate copy on the device, is not this kernel's."""

KERNEL = "probe_kernel"


def applies(frame: dict) -> bool:
    return "occupied_after" in frame


def count(frame: dict):
    new = max(frame["occupied_after"] - frame["occupied_before"], 0)
    e, live = frame["edge_slots"], frame["edges"]
    return (e + live * (8 + 8) + e * (4 + 1 + 1) + new * 8, 0)
