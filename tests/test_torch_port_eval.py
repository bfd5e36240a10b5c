"""The PyTorch port's eval tools and logging/profiling utils against the
JAX package's.

eval/normalizer.py (with its english_spelling.json), eval/wer.py and the
LibriSpeech and Earnings-21 runners of both packages on the same inputs:
equal normalized text, equal WER figures and equal runner output on a
fabricated dataset layout (the repository holds no real speech), with the
same tiny float32 checkpoint (token embedding scaled by 8, as in
test_torch_port_serving.py). utils/logging.py: CONT continues the previous
level, install_logging_hooks installs once. utils/profiling.py: a no-op
without a directory, a Chrome trace on the CPU with one."""

import json
import logging
import pathlib
import random

import numpy as np
import pytest
import torch

import whisper_tpu as wt
import whisper_tpu_torch as pt
from whisper_tpu.eval import earnings21 as jearn
from whisper_tpu.eval import librispeech as jlibri
from whisper_tpu.eval import normalizer as jnorm
from whisper_tpu.eval import wer as jwer
from whisper_tpu.utils import logging as jlog
from whisper_tpu_torch.errors import InitError
from whisper_tpu_torch.eval import earnings21 as pearn
from whisper_tpu_torch.eval import librispeech as plibri
from whisper_tpu_torch.eval import normalizer as pnorm
from whisper_tpu_torch.eval import wer as pwer
from whisper_tpu_torch.utils import logging as plog
from whisper_tpu_torch.utils import profiling

from test_torch_port_serving import (  # noqa: F401  (fixtures)
    float32_contexts,
    model_file,
    one_torch_thread,
    speech,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "data" / "normalizer_fixtures.json"

TEXTS = [
    "Twenty one dollars and fifty cents, please.",
    "It cost $20 million in 1984 — or £3.50, €7 and ¥100?",
    "The COLOUR of the neighbour's aeroplane; she apologised.",
    "thirty-second, one oh one, double oh seven, minus five, triple six",
    "Mr. Smith and Dr. Jones met at 3:45 p.m. on the 21st.",
    "fifty per cent of two hundred fifty thousand three hundred twelve",
    "I doesn't can't won't; they're hmm uh [noise] (cough) here",
    "three point one four and 1.5e3, 10,000 people, 1st 2nd 3rd",
    "Café œuvre ß naïve — ÉCOLE",
    "",
    "one",
    "the 1960s and the '90s, 2 3 4 five six",
]


def test_spelling_table_is_the_same_file():
    want = (ROOT / "whisper_tpu" / "eval" / "english_spelling.json").read_bytes()
    assert (ROOT / "whisper_tpu_torch" / "eval" / "english_spelling.json").read_bytes() == want


@pytest.mark.parametrize("text", TEXTS)
def test_normalizers_equal(text):
    assert pnorm.EnglishTextNormalizer()(text) == jnorm.EnglishTextNormalizer()(text)
    assert pnorm.BasicTextNormalizer()(text) == jnorm.BasicTextNormalizer()(text)
    assert pnorm.BasicTextNormalizer(remove_diacritics=True, split_letters=True)(text) == \
        jnorm.BasicTextNormalizer(remove_diacritics=True, split_letters=True)(text)
    assert pnorm.EnglishNumberNormalizer()(text) == jnorm.EnglishNumberNormalizer()(text)


def test_normalizer_fixture_corpus_equal():
    """Every input of the recorded reference corpus normalizes alike."""
    pn, jn = pnorm.EnglishTextNormalizer(), jnorm.EnglishTextNormalizer()
    cases = json.loads(FIXTURES.read_text())
    n = 0
    for case in cases:
        if "error" in case:
            for norm in (pn, jn):
                with pytest.raises(Exception):
                    norm(case["in"])
        else:
            assert pn(case["in"]) == jn(case["in"]) == case["out"], case["in"]
            n += 1
    assert n >= 200


@pytest.mark.parametrize("normalize", [False, True])
def test_wer_equal(normalize):
    refs = TEXTS[:8]
    hyps = [TEXTS[(i + 1) % 8] if i % 3 else t.upper() for i, t in enumerate(refs)]
    assert pwer.wer(refs, hyps, normalize=normalize) == \
        jwer.wer(refs, hyps, normalize=normalize)
    for r, h in zip(refs + ["", "a b"], hyps + ["x y", ""]):
        assert pwer.wer_details(r, h, normalize=normalize) == \
            jwer.wer_details(r, h, normalize=normalize)


def test_edit_distance_equal():
    rng = random.Random(7)
    vocab = list("abcdefg")
    for _ in range(200):
        r = [rng.choice(vocab) for _ in range(rng.randint(0, 12))]
        h = [rng.choice(vocab) for _ in range(rng.randint(0, 12))]
        S, D, I = pwer._edit_ops(r, h)
        assert (S, D, I) == jwer._edit_ops(r, h)
        assert pwer._edit_distance(r, h) == jwer._edit_distance(r, h) == S + D + I


# ------------------------------------------------------------------ runners

@pytest.fixture()
def librispeech(tmp_path):
    from whisper_tpu_torch.audio.io import write_wav
    root = tmp_path / "LibriSpeech" / "test-clean"
    d = root / "1" / "2"
    d.mkdir(parents=True)
    write_wav(str(d / "1-2-0001.wav"), speech(2, 0))
    write_wav(str(d / "1-2-0002.wav"), speech(3, 1))
    write_wav(str(d / "1-2-0003.wav"), speech(1, 2))            # no reference line
    (d / "1-2-0004.flac").write_bytes(b"fLaC")                 # undecodable
    (d / "1-2.trans.txt").write_text(
        "1-2-0001 HELLO WORLD\n1-2-0002 ASK NOT WHAT YOUR COUNTRY CAN DO\n"
        "1-2-0004 NEVER READ\n")
    return root


@pytest.fixture()
def earnings(tmp_path):
    from whisper_tpu_torch.audio.io import write_wav
    root = tmp_path / "earnings21"
    (root / "media").mkdir(parents=True)
    nlp = root / "transcripts" / "nlp_references"
    nlp.mkdir(parents=True)
    write_wav(str(root / "media" / "call1.wav"), speech(3, 3))
    write_wav(str(root / "media" / "call2.wav"), speech(2, 4))
    (nlp / "call1.nlp").write_text("token|speaker|ts\nhello|a|0\nworld|a|1\n\n|b|2\n")
    (nlp / "call2.nlp").write_text("token|speaker\nTwenty|a\nfive|a\npercent|b\n")
    (nlp / "call3.nlp").write_text("token|speaker\nno|a\nmedia|a\n")
    meta = root / "metadata.csv"
    meta.write_text("file,company\ncall2,x\ncall1,y\ncall9,z\n")
    return root


def test_runner_helpers_equal(librispeech, earnings):
    root = str(librispeech)
    assert plibri.load_references(root) == jlibri.load_references(root)
    assert plibri.find_audio(root) == jlibri.find_audio(root)
    assert pearn.load_references(str(earnings)) == jearn.load_references(str(earnings))
    meta = str(earnings / "metadata.csv")
    assert pearn.load_codes(meta) == jearn.load_codes(meta) == ["call1", "call2", "call9"]


@pytest.fixture()
def no_fallback(monkeypatch):
    """The runners decode without the temperature ladder: its sampled
    attempts draw from each framework's own generator."""
    from whisper_tpu.eval import common as jcommon
    for mod, attr in ((jcommon, "build_eval_context"), (plibri, "build_eval_context"),
                      (pearn, "build_eval_context")):
        orig = getattr(mod, attr)

        def build(args, _orig=orig):
            ctx, p = _orig(args)
            p.temperature_inc = 0.0
            return ctx, p
        monkeypatch.setattr(mod, attr, build)


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_librispeech_runner_equal(librispeech, model_file, float32_contexts, no_fallback,
                                  capsys, tmp_path):
    runs = []
    for name, mod, ng in (("jax", jlibri, []), ("port", plibri, ["-ng"])):
        hyp = tmp_path / f"hyp_{name}"
        rc, out, err = _run(mod.main, ["-m", model_file, "-d", str(librispeech.parent),
                                       "--hyp-dir", str(hyp), *ng], capsys)
        runs.append((rc, out, err, {p.name: p.read_text() for p in sorted(hyp.iterdir())}))
    assert runs[1] == runs[0]
    rc, out, _, hyps = runs[0]
    assert rc == 0 and out.startswith("WER: ") and "(2 utterances)" in out
    assert sorted(hyps) == ["1-2-0001.txt", "1-2-0002.txt"]


@pytest.mark.parametrize("meta", [False, True])
def test_earnings21_runner_equal(earnings, model_file, float32_contexts, no_fallback, capsys,
                                 meta):
    extra = ["--metadata", str(earnings / "metadata.csv")] if meta else []
    runs = [_run(mod.main, ["-m", model_file, "-d", str(earnings), *extra, *ng], capsys)
            for mod, ng in ((jearn, []), (pearn, ["-ng"]))]
    assert runs[1] == runs[0]
    rc, out, err = runs[0]
    assert rc == 0 and "(2 files)" in out
    # call3 has a reference but no media; the metadata leaves it out
    assert ("skipping call3 (no media)" in err) == (not meta)


def test_runners_need_cuda(librispeech, earnings, model_file):
    """Without -ng the runners ask for a CUDA device: InitError, no CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the runners run on it")
    with pytest.raises(InitError, match="use_gpu=False"):
        plibri.main(["-m", model_file, "-d", str(librispeech)])
    with pytest.raises(InitError, match="use_gpu=False"):
        pearn.main(["-m", model_file, "-d", str(earnings)])
    # nothing to evaluate is found before any context is built
    assert plibri.main(["-m", model_file, "-d", str(earnings / "media" / "none")]) == 1


def test_eval_context_options(model_file):
    """--draft-model with beam search is dropped (speculation is greedy);
    -bs sets the beam."""
    from whisper_tpu_torch.eval.common import build_eval_context
    args = type("Args", (), dict(model=model_file, beam_size=5, draft_model=model_file,
                                 no_gpu=True))()
    ctx, p = build_eval_context(args)
    assert ctx.draft is None and args.draft_model is None
    assert p.beam_search.beam_size == 5 and p.strategy == pt.SamplingStrategy.BEAM_SEARCH
    assert ctx.device.type == "cpu" and not p.print_progress


# ------------------------------------------------------------------ logging

@pytest.fixture()
def fresh_logging(monkeypatch):
    """Both logging modules as at import: no callback, hooks not installed,
    INFO as the last level."""
    for mod in (jlog, plog):
        monkeypatch.setattr(mod, "_callback", None)
        monkeypatch.setattr(mod, "_installed", False)
        monkeypatch.setattr(mod, "_last_level", mod.LogLevel.INFO)


SEQUENCE = [("ERROR", "disk "), ("CONT", "full\n"), ("INFO", "loaded\n"), ("CONT", "ok\n"),
            ("NONE", "hidden\n"), ("CONT", "still hidden\n"), ("WARN", "w\n"),
            ("DEBUG", "d\n"), ("CONT", "more d\n")]


def test_logging_default_writer_and_callback_equal(fresh_logging, capsys):
    out = []
    for mod in (jlog, plog):
        for lvl, msg in SEQUENCE:
            mod.log(mod.LogLevel[lvl], msg)
        mod.log_info("i")
        mod.log_warn("w")
        mod.log_error("e")
        mod.log_debug("g")
        seen = []
        mod.log_set(lambda level, msg, seen=seen: seen.append((level.name, msg)))
        for lvl, msg in SEQUENCE:
            mod.log(mod.LogLevel[lvl], msg)
            seen.append(mod._last_level.name)
        mod.log_set(None)
        out.append((capsys.readouterr().err, seen))
    assert out[1] == out[0]
    err, seen = out[0]
    assert "hidden" not in err and err.startswith("disk full\nloaded\nok\n")
    assert seen[:6] == [("ERROR", "disk "), "ERROR", ("CONT", "full\n"), "ERROR",
                        ("INFO", "loaded\n"), "INFO"]


def test_install_logging_hooks_cont_and_once(fresh_logging, caplog):
    caplog.set_level(logging.DEBUG)
    records = []
    for mod, name in ((jlog, "whisper_tpu"), (plog, "whisper_tpu_torch")):
        mod.install_logging_hooks()
        hook = mod._callback
        mod.install_logging_hooks()                 # Once: nothing changes
        assert mod._callback is hook and mod._installed
        caplog.clear()
        for lvl, msg in SEQUENCE:
            mod.log(mod.LogLevel[lvl], msg)
        records.append([(r.levelno, r.getMessage()) for r in caplog.records
                        if r.name == name])
        mod.log_set(lambda *a: None)                # a user's callback survives
        mod.install_logging_hooks()
        assert mod._callback is not hook
    assert records[1] == records[0]
    # CONT takes the previous message's level: a multi-part ERROR stays ERROR
    assert records[0][:4] == [(logging.ERROR, "disk "), (logging.ERROR, "full"),
                              (logging.INFO, "loaded"), (logging.INFO, "ok")]
    assert (logging.DEBUG, "more d") in records[0]
    assert logging.getLogger("whisper_tpu_torch") is plog.logger


def test_package_exports_logging():
    assert pt.log_set is plog.log_set and pt.LogLevel is plog.LogLevel
    assert pt.install_logging_hooks is plog.install_logging_hooks
    assert [(m.name, int(m)) for m in pt.LogLevel] == [(m.name, int(m)) for m in wt.LogLevel]


# ---------------------------------------------------------------- profiling

def test_profiling_trace(tmp_path):
    with profiling.trace(None):
        x = torch.ones(4) + 1
    with profiling.trace(""):
        x = x * 2
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "prof"
    with profiling.trace(str(out)):
        with profiling.annotate("port_probe_region"):
            y = torch.arange(64, dtype=torch.float32).reshape(8, 8) @ torch.ones(8, 8)
    files = list(out.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    doc = json.loads(files[0].read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "port_probe_region" in names
    assert float(y.sum()) == float(np.arange(64).sum() * 8)
