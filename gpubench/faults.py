"""Controls and faults: replacements of the entry point a cell's window
drives, each of which the check must find. ``core.run_cell(...,
wrap=...)`` puts one in the program's place from the warm-up on. Both are
chosen by the traffic mix's check: ``decoded`` (an answer that is the
input's bytes) or ``container`` (an answer that is the input's
container).

A replacement is ``make(original, cfg) -> function`` taking the entry's
arguments. The control breaks the guarantee the configuration states
with a path a later change might be tempted to take: for a decode, a
decode that loses each block's last byte; for a compress, the program's
other parse level (0 for 1, 1 for 0), a different container. The faults
are those a one-card codec can have (a call that returns its input
unchanged, half of the blocks left out, one byte of every block's answer
altered where it is produced, one byte of one block's answer altered),
and two that only the other numbers of a check catch: answers that
differ from call to call, and calls that fail.
"""

from __future__ import annotations

import struct

from .reference import tsq_codec as R

BLOCK = R.BLOCK
KINDS = ("decoded", "container")


def _decode_blocks(out: bytes, fn) -> bytes:
    return b"".join(fn(out[k:k + BLOCK]) for k in range(0, len(out), BLOCK))


def _container(c: bytes, keep, edit=lambda b, p: p) -> bytes:
    """The container ``c`` with only the blocks ``keep(n)`` names, each
    payload ``p`` of block ``b`` passed through ``edit(b, p)``; header
    fixed up."""
    n, total, table = R.parse_container(c)
    blocks = keep(n)
    sizes = [c[o] | c[o + 1] << 8 | c[o + 2] << 16 for o, _, _ in table]
    parts = [R.MAGIC + struct.pack("<IQ", len(blocks),
                                   sum(sizes[b] for b in blocks))]
    for b in blocks:
        o, s, e = table[b]
        p = edit(b, c[o:o + s])
        parts.append((len(p) | (R.EXT_FLAG if e else 0)).to_bytes(3, "little"))
        parts.append(p)
    return b"".join(parts)


def _flip_last(b: bytes) -> bytes:
    return b[:-1] + bytes([b[-1] ^ 0x5A]) if b else b


def _flip_middle(b: bytes) -> bytes:
    k = len(b) // 2
    return b[:k] + bytes([b[k] ^ 0x5A]) + b[k + 1:]


def control(kind: str):
    if kind == "container":
        def make(orig, cfg):
            def other_level(data, **kw):
                kw["level"] = 1 - cfg["level"]
                return orig(data, **kw)
            return other_level
    else:
        def make(orig, cfg):
            def lossy(stream, **kw):
                return _decode_blocks(orig(stream, **kw),
                                      lambda b: b[:-1] + b"\0")
            return lossy
    return make


def fault(name: str, kind: str):
    """The fault ``name`` (one of ``FAULTS``) for an entry whose answers
    the check ``kind`` (one of ``KINDS``) judges. ``one_block`` alters the
    middle byte of the middle block's answer only; ``flaky`` alters one byte
    of every block of every second call's answer; ``raises`` fails every
    call on an input it has seen before, so the warm-up passes and the
    window's calls fail."""
    def make(orig, cfg):
        calls, seen = [0], set()

        def broken(x, **kw):
            calls[0] += 1
            again = hash(x) in seen
            seen.add(hash(x))
            if name == "unchanged":
                return x
            if name == "raises" and again:
                raise RuntimeError("a planted fault")
            out = orig(x, **kw)
            if name == "raises" or (name == "flaky" and calls[0] % 2):
                return out
            if kind == "container":
                if name == "half":
                    return _container(out, lambda n: range(-(-n // 2)))
                if name == "one_block":
                    n = R.parse_container(out)[0]
                    return _container(out, range, lambda b, p: p if b != n
                                      // 2 else _flip_middle(p))
                return _container(out, range, lambda b, p: _flip_last(p))
            if name == "half":
                return out[:-(-len(out) // BLOCK) // 2 * BLOCK]
            if name == "one_block":
                k = (-(-len(out) // BLOCK) // 2) * BLOCK
                return out[:k] + _flip_middle(out[k:k + BLOCK]) + \
                    out[k + BLOCK:]
            return _decode_blocks(out, _flip_last)
        return broken
    return make


FAULTS = ("unchanged", "half", "altered", "one_block", "flaky", "raises")
