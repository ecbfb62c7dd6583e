"""What the benchmark's CPU tests share: tiny versions of the cells, and
entry points that run the program's native core in the card's place."""

from __future__ import annotations

from gpubench import core, faults

TINY = {
    "tsqb-text-l0.decode": {
        "config": {"generator_args": {"n_bytes": (4 << 20) + 300_001}}},
    "tsqb-text-l0.compress": {
        "config": {"generator_args": {"n_bytes": (4 << 20) + 300_001}}},
}


def native(orig, cfg):
    """The entry point on the native core (the card's bytes, on the
    host)."""
    def call(x, **kw):
        kw["backend"] = "native"
        kw.pop("device", None)
        return orig(x, **kw)
    return call


def entry(cell: str, mode: str):
    """``wrap`` for ``core.run_cell``: the native entry point, under the
    control or a fault where ``mode`` names one."""
    if mode == "sound":
        return native
    kind = core.find_cell(core.load_spec(), cell)[3]["check"]
    outer = (faults.control(kind) if mode == "control"
             else faults.fault(mode, kind))
    return lambda orig, cfg: outer(native(orig, cfg), cfg)
