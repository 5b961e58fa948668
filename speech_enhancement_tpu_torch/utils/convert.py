"""JAX TSCNet parameters -> this package's ``state_dict``, with numpy alone.

The same mapping as ``speech_enhancement_tpu/utils/convert_torch.py::
export_tscnet`` (``:355-472``), which needs JAX to unstack the scanned
blocks; this one takes the flax ``params`` and ``batch_stats`` trees as
nested dicts of numpy arrays, so it runs where JAX is not installed.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

Tree = Mapping[str, Any]


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(p: Tree, sd: dict, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _f32(p["kernel"]).T
    if "bias" in p:
        sd[f"{prefix}.bias"] = _f32(p["bias"])


def _conv2d(p: Tree, sd: dict, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _f32(p["kernel"]).transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if "bias" in p:
        sd[f"{prefix}.bias"] = _f32(p["bias"])


def _conv1d(p: Tree, sd: dict, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _f32(p["kernel"]).transpose(2, 1, 0)  # WIO -> OIW
    if "bias" in p:
        sd[f"{prefix}.bias"] = _f32(p["bias"])


def _norm(p: Tree, sd: dict, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _f32(p["scale"])
    sd[f"{prefix}.bias"] = _f32(p["bias"])


def _prelu(p: Tree, sd: dict, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _f32(p["alpha"])


def _dense_block(p: Tree, sd: dict, prefix: str) -> None:
    for i in range(1, 5):
        _conv2d(p[f"conv{i}"], sd, f"{prefix}.conv{i}")
        _norm(p[f"norm{i}"], sd, f"{prefix}.norm{i}")
        _prelu(p[f"prelu{i}"], sd, f"{prefix}.prelu{i}")


def _dense_encoder(p: Tree, sd: dict, prefix: str) -> None:
    _conv2d(p["conv1"], sd, f"{prefix}.conv_1.0")
    _norm(p["norm1"], sd, f"{prefix}.conv_1.1")
    _prelu(p["prelu1"], sd, f"{prefix}.conv_1.2")
    _dense_block(p["dense"], sd, f"{prefix}.dilated_dense")
    _conv2d(p["conv2"], sd, f"{prefix}.conv_2.0")
    _norm(p["norm2"], sd, f"{prefix}.conv_2.1")
    _prelu(p["prelu2"], sd, f"{prefix}.conv_2.2")


def _feed_forward(p: Tree, sd: dict, prefix: str) -> None:
    _norm(p["LayerNorm_0"], sd, f"{prefix}.fn.norm")
    _linear(p["Dense_0"], sd, f"{prefix}.fn.fn.net.0")
    _linear(p["Dense_1"], sd, f"{prefix}.fn.fn.net.3")


def _attention(p: Tree, sd: dict, prefix: str) -> None:
    _norm(p["LayerNorm_0"], sd, f"{prefix}.norm")
    _linear(p["to_q"], sd, f"{prefix}.fn.to_q")
    _linear(p["to_kv"], sd, f"{prefix}.fn.to_kv")
    _linear(p["to_out"], sd, f"{prefix}.fn.to_out")
    sd[f"{prefix}.fn.rel_pos_emb.weight"] = _f32(p["rel_pos_emb"])


def _conv_module(p: Tree, s: Tree, sd: dict, prefix: str) -> None:
    _norm(p["LayerNorm_0"], sd, f"{prefix}.net.0")
    _conv1d(p["Conv_0"], sd, f"{prefix}.net.2")
    _conv1d(p["Conv_1"], sd, f"{prefix}.net.4.conv")
    _norm(p["BatchNorm_0"], sd, f"{prefix}.net.5")
    sd[f"{prefix}.net.5.running_mean"] = _f32(s["BatchNorm_0"]["mean"])
    sd[f"{prefix}.net.5.running_var"] = _f32(s["BatchNorm_0"]["var"])
    # torch BatchNorm1d bookkeeping; strict loading requires it
    sd[f"{prefix}.net.5.num_batches_tracked"] = np.zeros((), np.int64)
    _conv1d(p["Conv_2"], sd, f"{prefix}.net.7")


def _conformer(p: Tree, s: Tree, sd: dict, prefix: str) -> None:
    _feed_forward(p["ff1"], sd, f"{prefix}ff1")
    _attention(p["attn"], sd, f"{prefix}attn")
    _conv_module(p["conv"], s["conv"], sd, f"{prefix}conv")
    _feed_forward(p["ff2"], sd, f"{prefix}ff2")
    _norm(p["LayerNorm_0"], sd, f"{prefix}post_norm")


def _mask_decoder(p: Tree, sd: dict, prefix: str) -> None:
    _dense_block(p["dense"], sd, f"{prefix}.dense_block")
    _conv2d(p["sub_pixel"]["conv"], sd, f"{prefix}.sub_pixel.conv")
    _conv2d(p["conv1"], sd, f"{prefix}.conv_1")
    _norm(p["norm"], sd, f"{prefix}.norm")
    _prelu(p["prelu"], sd, f"{prefix}.prelu")
    _conv2d(p["final_conv"], sd, f"{prefix}.final_conv")
    _prelu(p["prelu_out"], sd, f"{prefix}.prelu_out")


def _complex_decoder(p: Tree, sd: dict, prefix: str) -> None:
    _dense_block(p["dense"], sd, f"{prefix}.dense_block")
    _conv2d(p["sub_pixel"]["conv"], sd, f"{prefix}.sub_pixel.conv")
    _norm(p["norm"], sd, f"{prefix}.norm")
    _prelu(p["prelu"], sd, f"{prefix}.prelu")
    _conv2d(p["conv"], sd, f"{prefix}.conv")


def _index(tree: Tree, k: int) -> dict:
    """Slice ``k`` of every leaf of a nested dict (one scanned block)."""
    return {key: _index(val, k) if isinstance(val, Mapping) else np.asarray(val)[k]
            for key, val in tree.items()}


def state_dict_from_flax(params_np: Tree, batch_stats_np: Tree) -> dict[str, torch.Tensor]:
    """Flax ``TSCNet`` variables (``params``, ``batch_stats``; numpy leaves)
    -> this package's ``TSCNet`` state_dict.  The ``[4, ...]`` leaves of the
    scanned ``tscb_stack`` are unstacked into ``TSCB_1..4``."""
    sd: dict = {}
    _dense_encoder(params_np["dense_encoder"], sd, "dense_encoder")
    for k in range(4):
        blk_p = _index(params_np["tscb_stack"], k)["block"]
        blk_s = _index(batch_stats_np["tscb_stack"], k)["block"]
        for axis in ("time_conformer", "freq_conformer"):
            _conformer(blk_p[axis], blk_s[axis], sd, f"TSCB_{k + 1}.{axis}.")
    _mask_decoder(params_np["mask_decoder"], sd, "mask_decoder")
    _complex_decoder(params_np["complex_decoder"], sd, "complex_decoder")
    return _tensors(sd)


def conformer_state_dict(params_np: Tree, batch_stats_np: Tree) -> dict[str, torch.Tensor]:
    """One flax ``ConformerBlock``'s variables -> ``ConformerBlock`` state_dict."""
    sd: dict = {}
    _conformer(params_np, batch_stats_np, sd, "")
    return _tensors(sd)


def _tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {key: torch.tensor(val) for key, val in sd.items()}
