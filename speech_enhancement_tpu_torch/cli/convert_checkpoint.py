"""Convert a reference PyTorch checkpoint into a checkpoint directory of this
package, or (``--to-torch``) a GAN checkpoint of this package into the
reference's layout (port of speech_enhancement_tpu/cli/convert_checkpoint.py,
its GAN and diffusion-trainer branches).

The port's modules carry the reference's ``state_dict`` names, so a
conversion strips the ``module.`` prefix (DDP), loads the weights into the
port's module (``strict``: a missing or an extra key, or a shape that
differs, raises) and writes ``<output>/variables.pt``, which
``utils.load_variables`` (``main_gan``/``main_diffuse --init-from``, both
inference CLIs) reads.  The branch comes from the file's keys:

- **GAN** (``gen_state_dict`` and ``disc_state_dict``): ``TSCNet(64,
  n_fft // 2 + 1)`` and ``Discriminator(16)`` -> ``{"gen", "disc"}``; a
  file without a discriminator gets a freshly initialized one (inference
  does not use it)::

      python -m speech_enhancement_tpu_torch.cli.convert_checkpoint \\
          model_best.pth.tar converted
      python -m speech_enhancement_tpu_torch.cli.inference_gan --cfg ... -m converted -o out

- **diffusion trainer** (``arch`` and ``state_dict``): the structure
  decides (``merge_block`` keys: the diffusion TSCNet, whose width is read
  from them; else DiffuSE, whose layers, width, conditioner bins, hop and
  GroupNorm are read from the keys; the dilation cycle is not in the
  weights and is the reference's 10) -> ``{"model"}``, for
  ``inference_diffuse -a <arch> -m <output>`` or ``main_diffuse
  --init-from <output>`` with a config of the same sizes.

The standalone CDiffuSE ``weights.pt`` (``step`` and ``model``) is not
ported yet and raises.  Only weights convert: optimizer state is not
carried, so a converted checkpoint seeds evaluation or fine-tuning, not a
``--resume``.  ``--to-torch`` reads ``<checkpoint>/variables.pt`` of a GAN
checkpoint and writes the reference ``{epoch, arch, gen_state_dict,
disc_state_dict}`` file, with the ``module.`` prefixes the reference's
``inference_gan.load_model`` strips.  The JAX CLI's ``--hop``,
``--crop-len`` and ``--no-verify`` shaped its template check; loading into
the module is the check here, and needs none of them.

Unlike the other entry points, the converter runs on the host and has no
``--device``: it does no arithmetic, only loads state dicts strictly (the
key and shape check) and writes them back out.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import torch

from speech_enhancement_tpu_torch.models import DiffuSE, DiffusionTSCNet, Discriminator, TSCNet
from speech_enhancement_tpu_torch.utils.checkpoint import VARIABLES


def parse_option(argv=None):
    parser = argparse.ArgumentParser(
        "convert_checkpoint", description="reference .pth.tar -> checkpoint directory")
    parser.add_argument("checkpoint", help="reference torch checkpoint (e.g. "
                        "model_best.pth.tar), or with --to-torch a checkpoint directory")
    parser.add_argument("output", help="checkpoint directory to create, or with --to-torch "
                        "the .pth.tar to write")
    parser.add_argument("--n-fft", default=400, type=int,
                        help="STFT size of the TSCNet families (their bins: n_fft // 2 + 1)")
    parser.add_argument("--to-torch", action="store_true",
                        help="reverse direction: CHECKPOINT is a GAN checkpoint directory of "
                             "this package, OUTPUT the reference-layout .pth.tar to write")
    parser.add_argument("--epoch", default=0, type=int,
                        help="'epoch' field stamped into a --to-torch file")
    parser.add_argument("--arch", default="scp",
                        help="'arch' field stamped into a --to-torch file")
    return parser.parse_args(argv)


def strip_module_prefix(state_dict: dict) -> dict:
    """The state_dict without DDP's ``module.`` prefix."""
    return {k[7:] if k.startswith("module.") else k: v for k, v in state_dict.items()}


def _load(module: torch.nn.Module, state_dict: dict, what: str) -> dict:
    """``state_dict`` loaded into ``module`` (strict); returns the module's
    own state_dict.  A mismatch raises ``SystemExit`` naming ``what``."""
    try:
        module.load_state_dict(state_dict, strict=True)
    except RuntimeError as exc:
        raise SystemExit(f"{what}: the weights do not fit the model: {exc}") from exc
    return module.state_dict()


def diffuse_from_state_dict(sd: dict) -> DiffuSE:
    """The ``DiffuSE`` whose sizes the reference state_dict's keys and
    shapes give (``cli/convert_checkpoint.py:111-138``)."""
    n_layers = 0
    while f"residual_layers.{n_layers}.diffusion_projection.weight" in sd:
        n_layers += 1
    if n_layers == 0:
        raise SystemExit("no residual_layers.* keys: not a DiffuSE state_dict")
    root = sd["spectrogram_upsampler.conv1.weight"].shape[-1] // 2
    return DiffuSE(hop_length=root * root,
                   n_specs=sd["residual_layers.0.conditioner_projection.weight"].shape[1],
                   residual_channels=sd["input_projection.weight"].shape[0],
                   residual_layers=n_layers,
                   use_groupnorm="residual_layers.0.dilated_conv.0.weight" in sd, device="cpu")


def convert(path: str, n_fft: int = 400) -> dict:
    """The variables of reference checkpoint ``path``: ``{"gen", "disc"}``
    (GAN) or ``{"model"}`` with the arch under ``"arch"`` (diffusion
    trainer)."""
    try:  # tensors and plain containers only: unpickling can run code
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        raise SystemExit(f"{path}: holds objects other than tensors and plain containers, "
                         f"which this converter does not unpickle: {exc}") from exc
    if not isinstance(ckpt, dict):
        raise SystemExit(f"{path}: not a checkpoint dictionary")
    if "gen_state_dict" in ckpt:
        gen = TSCNet(64, n_fft // 2 + 1, device="cpu")
        out = {"gen": _load(gen, strip_module_prefix(ckpt["gen_state_dict"]), "gen_state_dict")}
        disc = Discriminator(16, device="cpu")
        if "disc_state_dict" in ckpt:
            out["disc"] = _load(disc, strip_module_prefix(ckpt["disc_state_dict"]),
                                "disc_state_dict")
        else:
            print("checkpoint has no disc_state_dict: writing a freshly initialized "
                  "discriminator (inference does not use it)")
            out["disc"] = disc.state_dict()
        return out
    if "disc_state_dict" in ckpt:
        raise SystemExit(f"{path}: has disc_state_dict but no gen_state_dict: nothing "
                         "servable to convert (inference_gan needs the generator)")
    if "state_dict" in ckpt:
        sd = strip_module_prefix(ckpt["state_dict"])
        arch = str(ckpt.get("arch", ""))
        is_tsc = "merge_block.merge_diffusion.weight" in sd
        structural = "tsc-diffuse" if is_tsc else "diffuse"
        if arch and arch.startswith("tsc") != is_tsc:
            print(f"WARNING: checkpoint says arch='{arch}' but the state_dict is structurally "
                  f"{structural}: converting as {structural}")
        if is_tsc:
            model = DiffusionTSCNet(sd["merge_block.output_residual.weight"].shape[0],
                                    n_fft // 2 + 1, device="cpu")
        else:
            model = diffuse_from_state_dict(sd)
        return {"arch": structural, "model": _load(model, sd, "state_dict")}
    if "model" in ckpt and "step" in ckpt:
        raise SystemExit(f"{path}: a standalone CDiffuSE weights.pt; its conversion is not "
                         "ported yet (the CDiffuSE slice)")
    raise SystemExit(f"{path}: unrecognized checkpoint layout (keys {sorted(ckpt)[:8]}): "
                     "expected a reference GAN .pth.tar or a main_diffuse .pth.tar")


def export_to_torch(checkpoint: str, output: str, epoch: int = 0, arch: str = "scp") -> None:
    """A GAN checkpoint directory of this package -> the reference
    ``.pth.tar`` layout (``main_gan.py:300-310`` keys, ``module.``
    prefixes included)."""
    src = Path(checkpoint) / VARIABLES
    if not src.exists():
        raise SystemExit(f"{checkpoint}: no {VARIABLES}: --to-torch needs a checkpoint "
                         "directory of this package, not a torch file")
    variables = torch.load(src, map_location="cpu", weights_only=True)
    if "gen" not in variables:
        raise SystemExit(f"{src}: no 'gen' entry: only GAN checkpoints export to the "
                         "reference layout")
    out = Path(output)
    if out.exists():
        raise SystemExit(f"{out} already exists; refusing to overwrite")
    out.parent.mkdir(parents=True, exist_ok=True)
    ckpt = {"epoch": epoch, "arch": arch}
    for key, name in (("gen", "gen_state_dict"), ("disc", "disc_state_dict")):
        if key in variables:
            ckpt[name] = {f"module.{k}": v for k, v in variables[key].items()}
    torch.save(ckpt, out)


def main(argv=None) -> int:
    args = parse_option(argv)
    if args.to_torch:
        export_to_torch(args.checkpoint, args.output, args.epoch, args.arch)
        print(f"wrote {args.output} (reference main_gan.py:300-310 layout)")
        return 0
    converted = convert(args.checkpoint, args.n_fft)
    out = Path(args.output)
    target = out / VARIABLES
    if target.exists():
        raise SystemExit(f"{target} already exists; refusing to overwrite")
    out.mkdir(parents=True, exist_ok=True)
    if "model" in converted:
        torch.save({"model": converted["model"]}, target)
        arch = converted["arch"]
        print(f"wrote {target} ({arch} model); serve it with\n"
              f"  python -m speech_enhancement_tpu_torch.cli.inference_diffuse -a {arch} "
              f"-m {out} ...\nor fine-tune with main_diffuse --init-from {out}")
    else:
        torch.save(converted, target)
        print(f"wrote {target} (gen + disc); serve it with\n"
              f"  python -m speech_enhancement_tpu_torch.cli.inference_gan --cfg <cfg> "
              f"-m {out} -o <outdir>")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
