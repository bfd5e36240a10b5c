"""Model quantizer — re-encode a ggml .bin with a target quantization type.

Counterpart of whisper_tpu/tools/quantize.py (reference
examples/quantize/quantize.cpp + examples/common-ggml.cpp:45-238): only
2-D float tensors get quantized; an explicit skip list keeps the conv
biases and positional embeddings; everything else passes through
unchanged. `quantize_tensors` applies the same rule to an in-memory tensor
dict, so a quantized checkpoint can be written without an f16 file first.

Usage: python -m whisper_tpu_torch.tools.quantize model.bin model-q5_0.bin q5_0
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import re
import sys
from typing import Dict, Sequence, Tuple

import numpy as np

from whisper_tpu_torch.checkpoint import ggml_io, quant

# reference quantize.cpp:159-166
SKIP_PATTERNS = [
    "encoder.conv1.bias",
    "encoder.conv2.bias",
    "encoder.positional_embedding",
    "decoder.positional_embedding",
]

NAME_TO_TYPE = {
    "q4_0": quant.GGML_TYPE_Q4_0,
    "q4_1": quant.GGML_TYPE_Q4_1,
    "q5_0": quant.GGML_TYPE_Q5_0,
    "q5_1": quant.GGML_TYPE_Q5_1,
    "q8_0": quant.GGML_TYPE_Q8_0,
    # K-quant super-block formats (reference common-ggml.cpp:12-16)
    "q2_k": quant.GGML_TYPE_Q2_K,
    "q3_k": quant.GGML_TYPE_Q3_K,
    "q4_k": quant.GGML_TYPE_Q4_K,
    "q5_k": quant.GGML_TYPE_Q5_K,
    "q6_k": quant.GGML_TYPE_Q6_K,
    "f16": quant.GGML_TYPE_F16,
    "f32": quant.GGML_TYPE_F32,
}


def output_type(name: str, ne: Sequence[int], ttype: int, qtype: int) -> int:
    """The ggml type a tensor is written in: `qtype` for a 2-D float
    tensor outside the skip list whose rows divide the block (256 for
    K-quants: the reference tool asserts inside ggml_quantize_chunk; such
    tensors pass through unquantized here, and per-tensor types keep the
    file loadable), its own type otherwise."""
    skip = any(re.fullmatch(p, name) for p in SKIP_PATTERNS)
    blk = quant.block_size(qtype) if qtype in quant.TYPE_TRAITS else 32
    do_quant = (not skip and len(ne) == 2
                and ttype in (quant.GGML_TYPE_F32, quant.GGML_TYPE_F16)
                and ne[0] % blk == 0)
    return qtype if do_quant else ttype


def quantize_tensors(tensors: Dict[str, Tuple[np.ndarray, int]],
                     qtype_name: str) -> Dict[str, ggml_io.RawTensor]:
    """{name: (float32 array in numpy shape, source ggml type)} -> {name:
    RawTensor encoded at its output type}, in the input's order, ready for
    ggml_io.write_ggml. The encodings run in up to 8 threads (numpy
    releases the GIL); the bytes do not depend on the thread count."""
    qtype = NAME_TO_TYPE[qtype_name.lower()]

    def encode(item):
        name, (arr, ttype) = item
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        ne = tuple(reversed(arr.shape))
        target = output_type(name, ne, ttype, qtype)
        return name, ggml_io.RawTensor(name, ne, target, quant.quantize(arr, target))

    with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return dict(pool.map(encode, tensors.items()))


def quantize_model(in_path: str, out_path: str, qtype_name: str) -> Dict[str, int]:
    """Returns per-tensor output types (for logging/tests)."""
    qtype = NAME_TO_TYPE[qtype_name.lower()]
    ckpt = ggml_io.read_ggml(in_path)
    out = quantize_tensors({name: (rt.to_float32(), rt.ttype)
                            for name, rt in ckpt.tensors.items()}, qtype_name)
    hp_out = dataclasses.replace(ckpt.hparams,
                                 ftype=quant.TYPE_TO_FTYPE.get(qtype, ckpt.hparams.ftype))
    ggml_io.write_ggml(out_path, hp_out, ckpt.mel_filters, ckpt.vocab_tokens, out)
    return {name: rt.ttype for name, rt in out.items()}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print("usage: quantize model-f32.bin model-quant.bin type\n"
              f"  type: {', '.join(NAME_TO_TYPE)}", file=sys.stderr)
        return 3
    in_path, out_path, qname = argv
    if qname.lower() not in NAME_TO_TYPE:
        print(f"error: invalid quantization type '{qname}'", file=sys.stderr)
        return 3
    log = quantize_model(in_path, out_path, qname)
    n_q = sum(1 for t in log.values() if t == NAME_TO_TYPE[qname.lower()])
    print(f"quantized {n_q}/{len(log)} tensors to {qname}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
