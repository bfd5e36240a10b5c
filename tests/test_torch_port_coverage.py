"""The port covers the reference's C API as the JAX package maps it.

API_MAP.md (checked in; generated from whisper.h's WHISPER_API exports)
maps each export to a `whisper_tpu.<module>:<attribute path>` symbol or to
N/A. Each mapped symbol, with `whisper_tpu.` read as `whisper_tpu_torch.`,
must resolve in the port, except the exports of a slice still to come,
named in NOT_YET_PORTED; those must still be missing, so the list shrinks
as slices land. It is empty: every mapped export resolves."""

import importlib
import pathlib
import re

import pytest

import whisper_tpu_torch as pt

API_MAP = pathlib.Path(__file__).resolve().parent.parent / "API_MAP.md"
ROWS = re.findall(r"^\| (\d+) \| `(whisper_\w+)` \| `([^`]+)` \|", API_MAP.read_text(), re.M)

NOT_YET_PORTED = set()


def resolve(symbol):
    """The port's object for a `whisper_tpu.<module>:<attr.path>` symbol."""
    module, attrs = symbol.split(":")
    obj = importlib.import_module("whisper_tpu_torch" + module[len("whisper_tpu"):])
    for name in attrs.split("."):
        obj = getattr(obj, name)
    return obj


def test_map_is_complete():
    assert len(ROWS) == 108                        # 120 exports, 12 of them N/A
    assert NOT_YET_PORTED <= {export for _, export, _ in ROWS}
    assert not NOT_YET_PORTED


@pytest.fixture(scope="module")
def state():
    from whisper_tpu_torch.checkpoint.init import tiny_test_hparams
    ctx = pt.WhisperContext.random(hp=tiny_test_hparams(),
                                   params=pt.ContextParams(use_gpu=False))
    return ctx.create_state()


@pytest.mark.parametrize("export,symbol", [(e, s) for _, e, s in ROWS],
                         ids=[e for _, e, _ in ROWS])
def test_export_resolves_in_the_port(state, export, symbol):
    if symbol == "inst-state:n_len":               # a WhisperState attribute
        assert isinstance(state.n_len, int)
        return
    assert symbol.startswith("whisper_tpu.")
    if export in NOT_YET_PORTED:
        with pytest.raises((ImportError, AttributeError)):
            resolve(symbol)
        return
    assert resolve(symbol) is not None
