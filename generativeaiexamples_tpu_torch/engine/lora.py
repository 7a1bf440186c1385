"""LoRA fine-tuning for the llama family (port of ``engine/lora.py``).

Adapters are a separate tree (stacked over layers like the base params);
gradients flow only through them (the base tree is a constant of the
loss, and its tensors never require grad), and the effective weight
``W + (alpha / r) * A @ B`` is formed inside the loss, so optimizer
state exists only for the adapters.  ``merge_lora`` bakes adapters into
the base weights for serving.

Adapter files keep the reference's ``.npz`` layout (``name.a`` /
``name.b``), so each package reads the other's.  bf16 adapters are
written as the reference writes them (numpy without ``ml_dtypes`` sees
2-byte void records) and read back through a ``uint16`` view, so no
``ml_dtypes`` is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.engine import training
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import f32

# Per-layer weights eligible for adaptation: name -> (in_dim, out_dim) fn.
_TARGET_DIMS = {
    "wq": lambda c: (c.d_model, c.n_heads * c.head_dim),
    "wk": lambda c: (c.d_model, c.n_kv_heads * c.head_dim),
    "wv": lambda c: (c.d_model, c.n_kv_heads * c.head_dim),
    "wo": lambda c: (c.n_heads * c.head_dim, c.d_model),
    "w_gate": lambda c: (c.d_model, c.d_ff),
    "w_up": lambda c: (c.d_model, c.d_ff),
    "w_down": lambda c: (c.d_ff, c.d_model),
}


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple = ("wq", "wk", "wv", "wo")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def __post_init__(self):
        unknown = set(self.targets) - set(_TARGET_DIMS)
        if unknown:
            raise ValueError(f"unknown LoRA targets {sorted(unknown)}")


_DENSE_MLP_TARGETS = ("w_gate", "w_up", "w_down")


def init_lora_params(cfg: llama.LlamaConfig, lora: LoRAConfig, generator: torch.Generator, device=None) -> dict:
    """A ~ N(0, 0.02) (drawn in f32 from ``generator``, then cast), B = 0,
    so the adapted model starts at the base.  ``device`` defaults to the
    card."""
    if cfg.n_experts > 1:
        bad = [t for t in lora.targets if t in _DENSE_MLP_TARGETS]
        if bad:
            raise ValueError(
                f"LoRA targets {bad} are dense-MLP leaves, but the config is MoE (n_experts > 1) — those params "
                "do not exist; target attention projections instead"
            )
    if not cfg.mlp_gated and "w_gate" in lora.targets:
        raise ValueError(
            "LoRA target 'w_gate' does not exist on ungated-MLP configs (mlp_gated=False, e.g. starcoder2); "
            "target w_up/w_down"
        )
    dev = resolve_device(device)
    out: dict = {}
    for name in lora.targets:
        d_in, d_out = _TARGET_DIMS[name](cfg)
        a = torch.randn((cfg.n_layers, d_in, lora.rank), generator=generator, dtype=torch.float32, device=dev)
        out[name] = {"a": (a * 0.02).to(cfg.compute_dtype),
                     "b": torch.zeros((cfg.n_layers, lora.rank, d_out), dtype=cfg.compute_dtype, device=dev)}
    return out


def _delta(a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """``einsum("lir,lro->lio", a, b) * scale`` in the adapters' dtype: an
    f32 product at IEEE precision (``ops.f32``), a bf16 one with f32
    accumulation rounded once, then the scale."""
    if a.dtype == torch.float32:
        return f32.einsum("lir,lro->lio", a, b) * scale
    return torch.einsum("lir,lro->lio", a, b) * scale


def apply_lora(params: llama.Params, lora_params: dict, lora: LoRAConfig, mesh=None) -> llama.Params:
    """Effective params: W + scale * A @ B per adapted layer weight (a pure
    function of base and adapters; the training loss differentiates it).

    With ``mesh`` (a rank's context) ``params`` holds this rank's shards
    and the adapters are whole: each rank forms only its slice of ``A @
    B``, B's columns for a target sharded on its output axis (wq, wk, wv,
    gate, up), A's rows for one sharded on its input axis (wo, down)."""
    layers = dict(params["layers"])
    for name, ab in lora_params.items():
        base = params["layers"][name]
        a, b = ab["a"], ab["b"]
        if mesh is not None and base.shape[1] != a.shape[1]:
            n = base.shape[1]
            a = a[:, mesh.index("tensor") * n : (mesh.index("tensor") + 1) * n]
        if mesh is not None and base.shape[2] != b.shape[2]:
            n = base.shape[2]
            b = b[:, :, mesh.index("tensor") * n : (mesh.index("tensor") + 1) * n]
        layers[name] = base + _delta(a, b, lora.scale).to(base.dtype)
    return {**params, "layers": layers}


@torch.no_grad()
def merge_lora(params: llama.Params, lora_params: dict, lora: LoRAConfig) -> llama.Params:
    """Bake adapters into base weights (serving-time merge)."""
    return apply_lora(params, lora_params, lora)


def make_lora_train_step(cfg: llama.LlamaConfig, lora: LoRAConfig, optimizer: training.AdamW,
                         base_params: llama.Params, mesh=None):
    """``train_step(state, batch) -> (state, metrics)`` over adapter params
    only: ``state.params`` is the adapter tree, ``base_params`` a constant
    of the loss (left bit for bit as it is).

    With ``mesh`` the base (a tree of tensors or numpy) is sent once and
    sharded by the default rules, the adapters are replicated on every
    rank (a one-device state is sent at the first step; the step returns
    a ``MeshTrainState``), each rank adapts its slice of each target
    (:func:`apply_lora`), and the adapters' gradients are summed over
    ``tensor`` and over the axes that split the batch."""
    if mesh is not None:
        from generativeaiexamples_tpu_torch.engine import mesh_training

        base_host = mesh_training.host_tree(base_params)

        def mesh_step(state, batch):
            if isinstance(state, training.TrainState):
                state = mesh_training.upload(mesh, "lora", cfg, optimizer, None, state, base=base_host, lora=lora)
            return mesh_training.run_step(state, batch)

        return mesh_step

    def loss(adapters, b):
        eff = apply_lora(base_params, adapters, lora)
        return training.loss_fn(eff, cfg, b["tokens"], b["targets"], b["mask"])

    def train_step(state: training.TrainState, batch):
        b = training._on(batch, training._device_of(state.params))
        loss_val, grads = training.value_and_grad(lambda p: loss(p, b), state.params)
        return training.apply_gradients(state, optimizer, loss_val, grads)

    return train_step


def init_lora_train_state(cfg: llama.LlamaConfig, lora: LoRAConfig, optimizer: training.AdamW,
                          generator: Optional[torch.Generator] = None, *, device=None) -> training.TrainState:
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    adapters = init_lora_params(cfg, lora, generator, dev)
    return training.TrainState(params=adapters, opt_state=optimizer.init(adapters), step=0)


# -- SFT data preparation ---------------------------------------------------


def sft_example(prompt_ids: Sequence[int], response_ids: Sequence[int], max_len: int,
                pad_id: int = 0) -> dict[str, np.ndarray]:
    """One (prompt, response) pair -> a next-token batch row with the loss
    masked to the response positions (positions whose *target* is in the
    response)."""
    ids = list(prompt_ids) + list(response_ids)
    ids = ids[: max_len + 1]
    tokens = ids[:-1]
    targets = ids[1:]
    mask = [1.0 if t >= len(prompt_ids) else 0.0 for t in range(1, len(ids))]
    pad = max_len - len(tokens)
    return {
        "tokens": np.asarray(tokens + [pad_id] * pad, np.int32),
        "targets": np.asarray(targets + [pad_id] * pad, np.int32),
        "mask": np.asarray(mask + [0.0] * pad, np.float32),
    }


def sft_batch(pairs: Sequence[tuple[Sequence[int], Sequence[int]]], max_len: int,
              pad_id: int = 0) -> dict[str, torch.Tensor]:
    """Rows of :func:`sft_example` stacked into CPU tensors."""
    rows = [sft_example(p, r, max_len, pad_id) for p, r in pairs]
    return {k: torch.from_numpy(np.stack([r[k] for r in rows])) for k in rows[0]}


# -- persistence ------------------------------------------------------------

_BF16_RECORD = np.dtype("V2")  # how numpy stores an ml_dtypes bfloat16 array


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def save_lora(lora_params: dict, path: str) -> None:
    """``name.a`` / ``name.b`` arrays in one ``.npz`` (the reference's layout
    and bytes)."""
    np.savez(path, **{f"{name}.{ab}": _to_numpy(mat) for name, d in lora_params.items() for ab, mat in d.items()})


def load_lora(path: str, dtype: Optional[torch.dtype] = None, device=None) -> dict:
    """An adapter ``.npz`` (the port's or the reference's) as tensors on
    ``device`` (the card by default), cast to ``dtype`` when given."""
    dev = resolve_device(device)
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            name, ab = key.rsplit(".", 1)
            t = _from_numpy(data[key]).to(dev)
            out.setdefault(name, {})[ab] = t.to(dtype) if dtype is not None else t
    return out
