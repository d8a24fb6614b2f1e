"""The program's own record as a loop hands it back
(``Result.extra["program"]``, the ``drive`` loop under ``--trace 1``), in
the shape ``benchmark/spans.py`` reads: a run's view with ``program`` and
``ctx``.  ``None`` in ``program`` where the loop has none."""

from __future__ import annotations

from types import SimpleNamespace


def view(run) -> SimpleNamespace:
    return SimpleNamespace(program=run.result.extra.get("program"),
                           ctx=run.ctx)
