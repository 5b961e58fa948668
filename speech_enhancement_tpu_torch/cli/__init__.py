"""Command-line entry points (run as
``python -m speech_enhancement_tpu_torch.cli.<name>``):

main_gan            SCP-GAN / CMGAN training
inference_gan       enhancement of a test directory and its six metrics
main_diffuse        DiffuSE / diffusion-TSCNet training
inference_diffuse   reverse sampling of a test directory and its six metrics
convert_checkpoint  reference .pth.tar checkpoints (GAN, diffusion trainer)
                    -> this package's checkpoint directory, and back for GAN

The training and inference CLIs run on ``cuda`` unless given
``--device cpu``; ``convert_checkpoint`` runs on the CPU.
"""
