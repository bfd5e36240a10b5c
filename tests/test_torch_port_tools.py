"""The port's micro_bench (the whisper_bench_memcpy / _ggml_mul_mat
exports) on the CPU: the JSON the JAX package's tool prints, with the
port's keys, finite and non-negative. No rate is asserted: on the CPU the
numbers are the host's, and a loaded host reads near 0."""

import json
import math

import pytest
import torch

from whisper_tpu_torch.checkpoint import quant
from whisper_tpu_torch.ops.quant_matmul import dequant_reference
from whisper_tpu_torch.tools import micro_bench


def test_micro_bench_cpu_json(capsys):
    assert micro_bench.main(["--cpu", "--mib", "4", "--sizes", "32", "64"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"device", "card", "membw_gbps", "membw_peak_gbps", "mul_mat",
                        "bf16_peak_tflops"}
    assert out["device"] == "cpu" and out["card"] is None
    assert (out["membw_peak_gbps"], out["bf16_peak_tflops"]) == (3350.0, 989.0)
    assert set(out["mul_mat"]) == {"32", "64"}
    values = [out["membw_gbps"]] + [v for r in out["mul_mat"].values() for v in r.values()]
    assert all(set(r) == {"bf16_tflops", "q8_tflops"} for r in out["mul_mat"].values())
    assert all(math.isfinite(v) and v >= 0 for v in values), out


def test_q8_probe_weight_is_q8_0():
    """The int8 probe multiplies Q8_0 blocks (qblock 32) of a seeded
    weight: its dequantization is the weight within Q8_0's rounding."""
    import numpy as np
    q, d = micro_bench.q8_0_weight(64, torch.device("cpu"))
    assert q.dtype == torch.int8 and q.shape == (64, 64) and d.shape == (2, 64)
    w = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    ref = quant.dequantize(quant.quantize(w, quant.GGML_TYPE_Q8_0), quant.GGML_TYPE_Q8_0,
                           w.size).reshape(64, 64)
    np.testing.assert_allclose(dequant_reference(q, d).T.numpy(), ref, rtol=0, atol=1e-6)


def test_micro_bench_without_card_refuses():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        micro_bench.bench_membw(1)
