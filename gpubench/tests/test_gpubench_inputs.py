"""The frozen generator: the same pool as the original it was copied
from, one input a seed, exact sizes, and pinned real files."""

import json
import shutil
from pathlib import Path

import pytest

from gpubench import core
from gpubench.gen import pools, text_standin

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("size,seed", [(300_000, 3), (4 << 20, 501)])
def test_synthetic_text_is_the_corpus_recipe(size, seed):
    from turbosqueeze_tpu_torch.utils import corpus
    assert pools.synthetic_text(size, seed) == corpus.synthetic_text(size,
                                                                     seed)


def test_generators_are_seeded():
    t = text_standin.generate(3, 10**6)
    assert t == text_standin.generate(3, 10**6)
    assert t != text_standin.generate(4, 10**6)


@pytest.mark.parametrize("n", [1, 499, 70_001, 10**6 + 7, (4 << 20) + 1])
def test_text_standin_size(n):
    assert len(text_standin.generate(2**31 + 5, n)) == n


def test_configs_state_their_sizes():
    text = core.read_json("configs", "tsqb-text-l0")
    assert text["bytes"] == text["generator_args"]["n_bytes"] == 10**9
    assert text["blocks"] == -(-text["bytes"] // text["block_bytes"])
    assert text["bytes"] - (text["blocks"] - 1) * (4 << 20) == \
        text["last_block_bytes"] == 1_755_648


def test_pins_hold_and_catch_a_change(tmp_path, monkeypatch):
    pins = json.loads(pools.PINS.read_text())
    assert sorted(pins) == sorted(f"tests/data/real/{n}.xz"
                                  for n in pools.REAL_FILES)
    for n in pools.REAL_FILES:
        assert pools.real_file(n)
    real = tmp_path / "tests" / "data" / "real"
    real.mkdir(parents=True)
    for n in pools.REAL_FILES:
        shutil.copy(REPO / "tests" / "data" / "real" / f"{n}.xz", real)
    monkeypatch.setattr(pools, "ROOT", tmp_path)
    assert pools.real_file("pydoc.txt")
    f = real / "pydoc.txt.xz"
    f.write_bytes(f.read_bytes() + b"\0")
    with pytest.raises(pools.PinError):
        pools.real_file("pydoc.txt")
    (real / "source.txt.xz").unlink()
    with pytest.raises(pools.PinError):
        pools.real_file("source.txt")
