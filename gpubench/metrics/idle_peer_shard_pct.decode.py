"""The share of the traced window, %, in which a card was idle while the
calling thread worked on another card's shard, as a mean over the cell's
cards.

An idle instant of card k counts where the innermost span open on the
calling thread (as ``gpubench/lib/spans.py::idle_by_span`` finds it), or
its nearest ancestor that names a card (the ``card`` count of a shard's
``decode.window`` and ``decode.drain``), names a card other than k. It is
a view across the idle shares by span (a peer's resolve, staging or wait),
not one more part of them. None where the window has no spans, or where no
span names a card (a program that does not count them)."""

from types import SimpleNamespace

from gpubench.lib import metric_math as M
from gpubench.lib import trace as T
from gpubench.lib.spans import idle_by_span, on_window

# the label of a span that works on a shard: the card it names
SHARD = "shard of card "


def _on_cards(spans):
    """The spans, each that names a card or has an ancestor that does
    relabelled ``SHARD`` and the nearest such card (an ancestor holds its
    child, so it is among the window's spans too)."""
    by_id = {s.id: s for s in spans}

    def card(s):
        while s is not None:
            if "card" in s.counts:
                return s.counts["card"]
            s = by_id.get(s.parent)
        return None

    out = []
    for s in spans:
        c = card(s)
        out.append(s if c is None else s._replace(name=f"{SHARD}{c}"))
    return out


def read(run):
    placed = on_window(run)
    if placed is None or not any("card" in s.counts for s, _, _ in placed):
        return None
    labelled = _on_cards([s for s, _, _ in placed])
    tr = run.trace
    peer = 0.0
    cards = M.cell_cards(run)
    for k in cards:
        # card k alone, as the one card of a run: its gaps by span
        alone = SimpleNamespace(setup_s=run.setup_s, cards=1, trace=T.Trace(
            tr.window_s, kernels=tr.device(k)))
        idle = idle_by_span(alone, labelled) or {}
        peer += sum(v for name, v in idle.items()
                    if name.startswith(SHARD) and name != f"{SHARD}{k}")
    return 100.0 * peer / (len(cards) * tr.window_s)
