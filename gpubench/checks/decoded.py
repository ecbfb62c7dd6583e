"""Every kept call's answer is the configuration's bytes: each 4 MiB
block of each output against the input's (every block, where an output
has the wrong length or is not bytes)."""

from gpubench.reference import checks


def check(kept: list, data: bytes, cfg: dict, seed: int,
          workers: int) -> dict:
    return {"bad_blocks": sum(checks.bad_blocks(out, data)
                              for _, out in kept)}
