"""Command-line entry points (run as
``python -m speech_enhancement_tpu_torch.cli.<name>``):

main_gan            SCP-GAN / CMGAN training
inference_gan       enhancement of a test directory and its six metrics
main_diffuse        DiffuSE / diffusion-TSCNet training
inference_diffuse   reverse sampling of a test directory and its six metrics
preprocess          CDiffuSE conditioner spectrograms of a wav directory
cdiffuse            standalone CDiffuSE training (step-granular learner)
cdiffuse_inference  standalone CDiffuSE reverse sampling of wavs
convert_checkpoint  reference checkpoints (GAN, diffusion trainer, CDiffuSE
                    weights.pt) -> this package's checkpoint directory, and
                    back for GAN

The training and inference CLIs run on ``cuda`` unless given
``--device cpu``; ``convert_checkpoint`` and ``preprocess`` run on the
host.
"""
