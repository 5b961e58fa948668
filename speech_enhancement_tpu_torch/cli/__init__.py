"""Command-line entry points (run as
``python -m speech_enhancement_tpu_torch.cli.<name>``):

main_gan        SCP-GAN / CMGAN training
inference_gan   enhancement of a test directory and its six metrics

Both run on ``cuda`` unless given ``--device cpu``.
"""
