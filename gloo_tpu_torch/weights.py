"""Parameters between the JAX tree and the port's Transformer.

The JAX model's parameters are a pytree of nested dicts and lists:
``embed`` (vocab, d), ``pos`` (max_seq_len, d) unless RoPE, ``ln_f.scale``
and ``layers[i].{ln1.scale, ln2.scale, wqkv, wo, w_up, w_down}``, dense
weights as (fan_in, fan_out). The port keeps the same names and layouts in
its state dict (``layers.<i>.wqkv`` ...), so conversion copies arrays and
checks shapes; nothing is transposed. ``tp_transformer_from_numpy`` goes
on to the world parameters of the tensor-parallel transformer
(gloo_tpu_torch.parallel.dp_tp), ``pipeline_stages_from_numpy`` to the
stages of a pipeline (gloo_tpu_torch.parallel.pp), one layer per rank.
"""

from __future__ import annotations

import numpy as np
import torch

from gloo_tpu_torch.device import resolve_device
from gloo_tpu_torch.models.transformer import Transformer, TransformerConfig
from gloo_tpu_torch.parallel.dp_tp import TPTransformer, shard_transformer
from gloo_tpu_torch.tpu.mesh import Mesh

_DENSE = ("wqkv", "wo", "w_up", "w_down")


def _expected_shapes(cfg: TransformerConfig) -> dict[str, tuple]:
    d = cfg.d_model
    kv_dim = cfg.head_dim * cfg.kv_heads
    shapes = {"embed": (cfg.vocab_size, d), "ln_f.scale": (d,)}
    if not cfg.use_rope:
        shapes["pos"] = (cfg.max_seq_len, d)
    for i in range(cfg.n_layers):
        shapes.update({
            f"layers.{i}.ln1.scale": (d,),
            f"layers.{i}.ln2.scale": (d,),
            f"layers.{i}.wqkv": (d, d + 2 * kv_dim),
            f"layers.{i}.wo": (d, d),
            f"layers.{i}.w_up": (d, cfg.d_ff),
            f"layers.{i}.w_down": (cfg.d_ff, d),
        })
    return shapes


def _flatten(tree) -> dict:
    flat = {"embed": tree["embed"], "ln_f.scale": tree["ln_f"]["scale"]}
    if "pos" in tree:
        flat["pos"] = tree["pos"]
    for i, layer in enumerate(tree["layers"]):
        for ln in ("ln1", "ln2"):
            flat[f"layers.{i}.{ln}.scale"] = layer[ln]["scale"]
        for name in _DENSE:
            flat[f"layers.{i}.{name}"] = layer[name]
    return flat


def _check(flat: dict, cfg: TransformerConfig) -> None:
    want = _expected_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(
            f"parameters do not match the config: missing "
            f"{sorted(set(want) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(want))}")
    for name, shape in want.items():
        if tuple(flat[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(flat[name].shape)}, "
                             f"the config needs {shape}")


def transformer_params_from_numpy(tree, cfg: TransformerConfig,
                                  device="cuda") -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> state dict for
    ``Transformer(cfg, device).load_state_dict``, f32 on `device`."""
    dev = resolve_device(device)
    flat = _flatten(tree)
    _check(flat, cfg)
    return {name: torch.tensor(np.asarray(x, dtype=np.float32), device=dev)
            for name, x in flat.items()}


def transformer_params_to_numpy(state_dict, cfg: TransformerConfig) -> dict:
    """The reverse: a Transformer state dict -> the JAX parameter tree with
    f32 numpy leaves."""
    _check(state_dict, cfg)

    def arr(name):
        return state_dict[name].detach().to("cpu", torch.float32).numpy()

    tree = {"embed": arr("embed"), "ln_f": {"scale": arr("ln_f.scale")},
            "layers": []}
    if not cfg.use_rope:
        tree["pos"] = arr("pos")
    for i in range(cfg.n_layers):
        layer = {ln: {"scale": arr(f"layers.{i}.{ln}.scale")}
                 for ln in ("ln1", "ln2")}
        layer.update({name: arr(f"layers.{i}.{name}") for name in _DENSE})
        tree["layers"].append(layer)
    return tree


def tp_transformer_from_numpy(tree, cfg: TransformerConfig, mesh: Mesh,
                              axis: str = "model") -> TPTransformer:
    """JAX parameter tree (numpy leaves) -> the TPTransformer on `mesh`,
    tensor parallel along `axis`: transformer_params_from_numpy, then
    shard_transformer."""
    model = Transformer(cfg, device=mesh.device)
    model.load_state_dict(
        transformer_params_from_numpy(tree, cfg, mesh.device))
    return shard_transformer(model, mesh, axis)


def pipeline_stages_from_numpy(tree, cfg: TransformerConfig,
                               mesh: Mesh) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the world parameters of a
    pipeline of its layers over `mesh`: layer i of the tree is the stage of
    flat rank i, so {"ln1.scale" (P, d), "ln2.scale", "wqkv", "wo", "w_up",
    "w_down"} f32 on the mesh's device, the parameters models.transformer.
    world_block takes. The tree needs one layer per rank; embed, pos and
    ln_f stay in the tree. On a process mesh, the rows of its local
    ranks."""
    flat = _flatten(tree)
    _check(flat, cfg)
    if cfg.n_layers != mesh.size:
        raise ValueError(f"{cfg.n_layers} layers for a pipeline of "
                         f"{mesh.size} ranks; need one layer per rank")
    names = ("ln1.scale", "ln2.scale") + _DENSE
    return {name: torch.tensor(np.stack(
        [np.asarray(flat[f"layers.{i}.{name}"], dtype=np.float32)
         for i in mesh.local_ranks]), device=mesh.device) for name in names}
