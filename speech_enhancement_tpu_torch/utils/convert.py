"""JAX TSCNet, Discriminator, DiffuSE and diffusion-TSCNet variables ->
this package's ``state_dict``, with numpy alone.

The same mappings as ``speech_enhancement_tpu/utils/convert_torch.py::
export_tscnet`` (``:452-472``), which needs JAX to unstack the scanned
blocks, and ``export_discriminator`` (``:475-502``), and the exact
inverses of its ``convert_diffuse`` and ``convert_tsc_diffusion``
(``:287-352``); these take the flax variable trees as nested dicts of
numpy arrays, so they run where JAX is not installed.
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


def discriminator_state_dict_from_flax(params_np: Tree,
                                      spectral_np: Tree) -> dict[str, torch.Tensor]:
    """Flax ``Discriminator`` variables (``params``, ``spectral``; numpy
    leaves) -> this package's ``Discriminator`` state_dict: SN convs at
    ``layers.0/3/6/9`` (``weight_orig``, ``weight_u``, ``weight_v``), their
    InstanceNorm and PReLU one and two after, the SN linears at
    ``layers.14`` and ``layers.17``, PReLU ``layers.16`` and the sigmoid's
    ``slope`` at ``layers.18``.  A conv's v is re-flattened from flax's
    ``(kh, kw, in)`` order to torch's ``(in, kh, kw)``."""
    sd: dict = {}
    for i, lid in enumerate((0, 3, 6, 9), start=1):
        kernel = _f32(params_np[f"conv{i}"]["kernel"])  # [kh, kw, in, out]
        sd[f"layers.{lid}.weight_orig"] = kernel.transpose(3, 2, 0, 1)
        sd[f"layers.{lid}.weight_u"] = _f32(spectral_np[f"conv{i}"]["u"])
        kh, kw, cin, _ = kernel.shape
        v = _f32(spectral_np[f"conv{i}"]["v"]).reshape(kh, kw, cin)
        sd[f"layers.{lid}.weight_v"] = v.transpose(2, 0, 1).reshape(-1)
        _norm(params_np[f"norm{i}"], sd, f"layers.{lid + 1}")
        _prelu(params_np[f"prelu{i}"], sd, f"layers.{lid + 2}")
    for name, lid in (("fc1", 14), ("fc2", 17)):
        sd[f"layers.{lid}.weight_orig"] = _f32(params_np[name]["kernel"]).T
        sd[f"layers.{lid}.bias"] = _f32(params_np[name]["bias"])
        sd[f"layers.{lid}.weight_u"] = _f32(spectral_np[name]["u"])
        sd[f"layers.{lid}.weight_v"] = _f32(spectral_np[name]["v"])
    _prelu(params_np["prelu_fc"], sd, "layers.16")
    sd["layers.18.slope"] = _f32(params_np["sigmoid"]["slope"])
    return _tensors(sd)


def _embedding(p: Tree, sd: dict, prefix: str) -> None:
    _linear(p["projection1"], sd, f"{prefix}.projection1")
    _linear(p["projection2"], sd, f"{prefix}.projection2")


def _residual_block(p: Tree, sd: dict, prefix: str, use_groupnorm: bool) -> None:
    if use_groupnorm:
        _conv1d(p["dilated_conv"], sd, f"{prefix}.dilated_conv.0")
        _norm(p["dilated_norm"], sd, f"{prefix}.dilated_conv.1")
        _conv1d(p["output_projection"], sd, f"{prefix}.output_projection.0")
        _norm(p["output_norm"], sd, f"{prefix}.output_projection.1")
    else:
        _conv1d(p["dilated_conv"], sd, f"{prefix}.dilated_conv")
        _conv1d(p["output_projection"], sd, f"{prefix}.output_projection")
    _linear(p["diffusion_projection"], sd, f"{prefix}.diffusion_projection")
    _conv1d(p["conditioner_projection"], sd, f"{prefix}.conditioner_projection")
    _conv1d(p["output_residual"], sd, f"{prefix}.output_residual")


def residual_block_state_dict(params_np: Tree,
                              use_groupnorm: bool = True) -> dict[str, torch.Tensor]:
    """One flax DiffuSE ``ResidualBlock``'s params -> ``ResidualBlock``
    state_dict."""
    sd: dict = {}
    _residual_block(params_np, sd, "", use_groupnorm)
    return _tensors({k[1:]: v for k, v in sd.items()})


def diffuse_state_dict_from_flax(params_np: Tree,
                                 use_groupnorm: bool = True) -> dict[str, torch.Tensor]:
    """Flax ``DiffuSE`` params (numpy leaves) -> this package's ``DiffuSE``
    state_dict, the inverse of ``convert_diffuse``.  The upsampler's flax
    kernel ``[2L, 3, 1, 1]`` (time, freq) is flipped on both axes and
    transposed back to torch's ``[1, 1, 3, 2L]`` (freq, time)."""
    sd: dict = {}
    _conv1d(params_np["input_projection"], sd, "input_projection")
    _embedding(params_np["diffusion_embedding"], sd, "diffusion_embedding")
    up = params_np["spectrogram_upsampler"]
    for name in ("conv1", "conv2"):
        kernel = np.flip(_f32(up[name])[:, :, 0, 0], (0, 1)).T
        sd[f"spectrogram_upsampler.{name}.weight"] = kernel[None, None].copy()
        sd[f"spectrogram_upsampler.{name}.bias"] = _f32(up[f"{name}_bias"])
    n = 0
    while f"residual{n}" in params_np:
        _residual_block(params_np[f"residual{n}"], sd, f"residual_layers.{n}", use_groupnorm)
        n += 1
    _conv1d(params_np["skip_projection"], sd, "skip_projection")
    _conv1d(params_np["output_projection"], sd, "output_projection")
    return _tensors(sd)


def tsc_diffusion_state_dict_from_flax(params_np: Tree,
                                       batch_stats_np: Tree) -> dict[str, torch.Tensor]:
    """Flax ``DiffusionTSCNet`` variables (``params``, ``batch_stats``;
    numpy leaves) -> this package's ``DiffusionTSCNet`` state_dict, the
    inverse of ``convert_tsc_diffusion``: the one ``merge_block``, and
    ``tscb1..4`` to ``TSCB_1..4``."""
    sd: dict = {}
    _dense_encoder(params_np["dense_encoder"], sd, "dense_encoder")
    _dense_encoder(params_np["dense_encoder_noisy"], sd, "dense_encoder_noisy")
    merge = params_np["merge_block"]
    _embedding(merge["diffusion_embedding"], sd, "merge_block.diffusion_embedding")
    _linear(merge["diffusion_projection"], sd, "merge_block.diffusion_projection")
    for name in ("merge_diffusion", "conditioner_projection", "output_residual"):
        _conv2d(merge[name], sd, f"merge_block.{name}")
    for k in range(1, 5):
        blk_p, blk_s = params_np[f"tscb{k}"], batch_stats_np[f"tscb{k}"]
        for axis in ("time_conformer", "freq_conformer"):
            _conformer(blk_p[axis], blk_s[axis], sd, f"TSCB_{k}.{axis}.")
    _mask_decoder(params_np["mask_decoder"], sd, "mask_decoder")
    _complex_decoder(params_np["complex_decoder"], sd, "complex_decoder")
    return _tensors(sd)


def _tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {key: torch.tensor(val) for key, val in sd.items()}
