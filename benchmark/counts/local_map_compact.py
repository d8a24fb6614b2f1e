"""K7, the local map's extraction (``csrc/local_map_compact.cu``): the
bytes one launch's inputs need.

It reads every slot's mask, the cell keys of the occupied slots (12
bytes each) and the points of the slots it keeps, and writes the whole
received buffer (12 bytes of point and a mask byte a row) and the count.
Whether a key is in the neighbourhood is a hash or a search: no operation
count is fixed by the inputs, so the bound is the bytes alone."""

KERNEL = "compact_kernel"


def applies(frame: dict) -> bool:
    return "occupied_after" in frame


def count(frame: dict):
    kept = min(frame["hits"], frame["local_slots"])
    return (frame["map_slots"] + frame["occupied_after"] * 12 + kept * 12
            + frame["local_slots"] * (12 + 1) + 4, 0)
