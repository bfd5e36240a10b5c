"""Device mesh and sharding specs for multi-card execution.

Counterpart of the JAX package's parallel/mesh.py. The reference scales
out with POSIX threads plus an optional TCP tensor-RPC backend; the JAX
package replaces it with a 2-D `jax.sharding.Mesh` over which GSPMD
partitions the program. The port keeps the two axes over
`torch.distributed`, one rank per card (or several ranks sharing a card
over gloo):

  dim "data"  — utterance batch data parallelism: each data coordinate
                transcribes its own share of the utterances
                (decoding/batch_full.py);
  dim "model" — Megatron tensor parallelism: QKV and mlp_0 split on the
                output features (whole heads), the attention out
                projections and mlp_2 on the input features, followed by
                an all-reduce over the model group (models/whisper.py,
                `tp=`).

A `DeviceMesh` names the ranks; `param_specs` states which dim of each
parameter splits over "model"; `shard_params` cuts this rank's shard.
Specs are tuples with one entry per tensor dim, "model" (or "data") where
the dim splits and None where it does not, as a PartitionSpec reads.

The port's layout (checkpoint/loader.py) differs from the JAX package's:
a dense `w` is [out, in], so output-sharded splits dim 0 and
input-sharded dim 1; a keep_quantized `q` is (in, out) and `d` / `m`
(in / qblock, out), so it is the other way round. The conv stem is
replicated (the JAX package shards its output channels): it is a few
percent of the encoder's work, and replicating it keeps the stem's
arithmetic the unsharded model's. Megatron sharding splits whole heads,
so the model dim must divide both head counts (GSPMD could split a head,
the port cannot), and a shard of a quantized input dim must hold whole
qblocks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from whisper_tpu_torch.config import WhisperHParams
from whisper_tpu_torch.errors import InitError

Spec = Tuple[Optional[str], ...]


def _mesh(grid: torch.Tensor, device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise ValueError("torch.distributed is not initialized "
                         "(parallel.distributed.init_distributed)")
    if grid.numel() > dist.get_world_size():
        raise ValueError(f"need {grid.numel()} ranks, have {dist.get_world_size()}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise InitError("a cuda mesh but no CUDA device is available; pass "
                        "device_type='cpu' to run on the CPU")
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def make_mesh(n_data: int = 1, n_model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """The (n_data, n_model) mesh over ranks 0 .. n_data*n_model - 1 in
    row-major order, as the JAX package reshapes jax.devices(): a model
    group is n_model consecutive ranks (one host's cards, where ranks are
    numbered host by host). Every rank of the world calls it (the group
    set-up is collective). The mesh is of cards (raising InitError
    without one) unless `device_type` is "cpu"; the collectives use the
    world's backend."""
    return _mesh(torch.arange(n_data * n_model).reshape(n_data, n_model), device_type)


def make_cross_host_mesh(n_data: int = 1, n_model: int = 1,
                         device_type: str = "cuda") -> DeviceMesh:
    """The transposed grid: grid[i, j] = rank j * n_data + i, so with
    ranks numbered host by host (n_data ranks a host, n_model hosts) the
    model dim spans the hosts and every tensor-parallel collective
    crosses the inter-host link, as the JAX package's
    make_cross_host_mesh does with processes."""
    return _mesh(torch.arange(n_data * n_model).reshape(n_model, n_data).T, device_type)


def model_group(mesh: DeviceMesh):
    """This rank's model-dim process group, or None when the model dim is
    1 (no tensor parallelism)."""
    return mesh.get_group("model") if mesh.size(1) > 1 else None


# linear roles: True = output-feature (head) sharded, False = input sharded
_BLOCK_ROLES = {
    "attn_q": True, "attn_k": True, "attn_v": True, "attn_out": False,
    "mlp_0": True, "mlp_2": False,
    "cross_q": True, "cross_k": True, "cross_v": True, "cross_out": False,
}
_LN_SPEC = {"scale": (None,), "bias": (None,)}


def _lin_spec(leaf: Dict[str, Any], out_sharded: bool, m) -> Dict[str, Spec]:
    """Specs of one linear's leaves: dense {w [out, in], b (out,)} or
    keep_quantized {q (in, out), d / m (in/qb, out), b}."""
    spec: Dict[str, Spec] = {}
    for k in leaf:
        if k == "w":
            spec[k] = (m, None) if out_sharded else (None, m)
        elif k in ("q", "d", "m"):
            spec[k] = (None, m) if out_sharded else (m, None)
        elif k == "b":
            # an input-sharded linear adds its bias once, after the reduce
            spec[k] = (m,) if out_sharded else (None,)
    return spec


def _block_specs(blk: Dict[str, Any], m) -> Dict[str, Any]:
    return {name: _LN_SPEC if name.endswith("_ln") else _lin_spec(leaf, _BLOCK_ROLES[name], m)
            for name, leaf in blk.items()}


def param_specs(params: Dict[str, Any], tp: bool = True,
                n_model: int = 0) -> Dict[str, Any]:
    """The spec tree of a parameter tree in checkpoint/loader.py's layout
    (built from the params, so the bf16 and keep_quantized layouts both
    come out right). With n_model given, the token embedding is
    vocab-sharded only when the vocab divides by it, and replicated
    otherwise (51865 and 51866 are both twice a prime, so TP = 4
    replicates it)."""
    m = "model" if tp else None
    vocab_rows = params["decoder"]["token_embed"].shape[0]
    emb_m = m if (not n_model or vocab_rows % n_model == 0) else None
    conv = {"w": (None, None, None), "b": (None,)}
    return {
        "encoder": {
            "pos_embed": (None, None),
            "conv1": conv,
            "conv2": conv,
            "ln_post": _LN_SPEC,
            "blocks": [_block_specs(b, m) for b in params["encoder"]["blocks"]],
        },
        "decoder": {
            "pos_embed": (None, None),
            # vocab rows: the logits are gathered over the model group
            "token_embed": (emb_m, None),
            "ln": _LN_SPEC,
            "blocks": [_block_specs(b, m) for b in params["decoder"]["blocks"]],
        },
    }


def _map(fn, tree, specs, path=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k], f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, s, f"{path}.{i}") for i, (v, s) in enumerate(zip(tree, specs))]
    return fn(tree, specs, path)


def _check_heads(hp: WhisperHParams, n_model: int) -> None:
    for name in ("n_audio_head", "n_text_head"):
        if getattr(hp, name) % n_model:
            raise ValueError(f"tensor parallelism splits whole heads: {name} = "
                             f"{getattr(hp, name)} does not divide by n_model = {n_model}")


def shard_params(params: Dict[str, Any], mesh: DeviceMesh, hparams: WhisperHParams,
                 tp: bool = True) -> Dict[str, Any]:
    """This rank's shard of the parameter tree: each leaf whose spec names
    "model" is cut into n_model equal parts along that dim and the part of
    this rank's model coordinate kept, copied to a tensor of its own on
    the leaf's device (contiguous, since the quant_matmul kernel wants
    contiguous, 16-byte-aligned q, d and m; and never a view, which would
    keep the whole leaf's storage alive). Cut from host params (api.WhisperContext with
    ContextParams.mesh_shape), only the shard reaches the card. Raises
    ValueError when n_model
    does not divide the head counts or a sharded dim, or when a shard of a
    quantized input dim is not a whole number of qblocks."""
    n_model = mesh.size(1)
    if not tp or n_model == 1:
        return params
    _check_heads(hparams, n_model)
    rank = mesh.get_local_rank("model")     # = the rank in the model group
    specs = param_specs(params, tp=True, n_model=n_model)

    for part in ("encoder", "decoder"):
        for li, blk in enumerate(params[part]["blocks"]):
            for name, leaf in blk.items():
                if "q" in leaf and not _BLOCK_ROLES[name]:
                    qb = leaf["q"].shape[0] // leaf["d"].shape[0]
                    if (leaf["q"].shape[0] // n_model) % qb:
                        raise ValueError(
                            f"{part}.blocks.{li}.{name}: an input shard of "
                            f"{leaf['q'].shape[0] // n_model} rows is not a whole "
                            f"number of {qb}-row qblocks")

    def cut(x: torch.Tensor, spec: Spec, path: str) -> torch.Tensor:
        if "model" not in spec:
            return x
        dim = spec.index("model")
        if x.shape[dim] % n_model:
            raise ValueError(f"{path}: dim {dim} of {tuple(x.shape)} does not divide "
                             f"by n_model = {n_model}")
        return x.chunk(n_model, dim)[rank].clone(memory_format=torch.contiguous_format)

    return _map(cut, params, specs)


def batch_sharding() -> Spec:
    """The utterance batch (its leading dim) splits over "data"."""
    return ("data",)


def kv_sharding() -> Spec:
    """KV caches (L, B, H, T, Dh): rows over data, heads over model
    (models/whisper.py KVCache.zeros)."""
    return (None, "data", "model", None, None)


def kv_scale_sharding() -> Spec:
    """Int8-cache scales (L, B, H, T): follow the codes' layout."""
    return (None, "data", "model", None)


def shard_shape(shape: Sequence[int], spec: Spec, n_data: int = 1,
                n_model: int = 1) -> Tuple[int, ...]:
    """The per-rank shape of a tensor of `shape` laid out by `spec` over a
    mesh (n_data, n_model); dims past the spec's end are whole, as a
    PartitionSpec reads."""
    sizes = {"data": n_data, "model": n_model}
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n if s is None else n // sizes[s] for n, s in zip(shape, spec))
