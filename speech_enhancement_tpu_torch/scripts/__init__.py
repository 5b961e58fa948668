"""The quality scripts (ports of the repository's ``scripts/`` of the same
names), each run as ``python -m speech_enhancement_tpu_torch.scripts.<name>``:

train_quality_proxy      the synthetic speech corpus, the proxy report
                         writer, and one GAN arm trained through
                         ``cli.main_gan`` and swept through
                         ``cli.inference_gan``
check_precision_quality  PESQ of each fast serving mode's output against
                         the full-fp32 output of ``TSCNet(64, 201)``
arch_ab_rich             the 3 arches x 3 seeds GAN matrix on the rich corpus
train_diffusion_proxy    DiffuSE / diffusion TSCNet through ``cli.main_diffuse``
                         and ``cli.inference_diffuse``
train_cdiffuse_proxy     standalone CDiffuSE through ``cli.cdiffuse`` and
                         ``cli.cdiffuse_inference``

Each takes ``--device`` (default ``cuda``, raising on a host without a
card; ``cpu`` runs on the CPU) and ``main(argv=None)``.  Reports and
records are written under ``--root`` unless ``--report`` says otherwise.
"""
