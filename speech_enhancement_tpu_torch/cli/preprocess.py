"""Offline spectrogram preprocessing for standalone CDiffuSE (port of
speech_enhancement_tpu/cli/preprocess.py).

Usage:
  python -m speech_enhancement_tpu_torch.cli.preprocess <indir> <outdir> [--se|--voc] \\
      [--workers 10]

Writes ``<outdir>/<name>.wav.spec.npy`` for every wav under ``<indir>``:
the 201-bin log1p-magnitude STFT (``--se``, the default) or the 80-mel
vocoder features (``--voc``), on the host.
"""

from __future__ import annotations

import argparse

from speech_enhancement_tpu_torch.data.preprocess import preprocess_dir


def main(argv=None) -> list[str]:
    """Returns the paths written."""
    parser = argparse.ArgumentParser(
        description="prepares spectrogram conditioner files for CDiffuSE")
    parser.add_argument("indir", help="directory containing .wav files")
    parser.add_argument("outdir", help="output directory for .wav.spec.npy")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--se", action="store_true", default=True,
                      help="201-bin log1p-magnitude STFT (default)")
    mode.add_argument("--voc", action="store_true", help="80-mel vocoder features")
    parser.add_argument("--workers", default=10, type=int)
    args = parser.parse_args(argv)
    files = preprocess_dir(args.indir, args.outdir, se=not args.voc, max_workers=args.workers)
    print(f"wrote {len(files)} spectrogram files to {args.outdir}")
    return files


if __name__ == "__main__":
    main()
