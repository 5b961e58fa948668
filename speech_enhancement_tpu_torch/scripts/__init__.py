"""The quality, long-run and runbook scripts (ports of the repository's
``scripts/`` of the same names), each run as
``python -m speech_enhancement_tpu_torch.scripts.<name>``:

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
run_full_recipe_proxy    the 100-epoch recipe in a ``cli.main_gan`` child,
                         SIGKILLed after epoch 24 and resumed with
                         ``--resume auto``, and the sweep of every checkpoint
label_bias_study         six GAN proxy arms with perturbed PESQ labels
run_quality_parity       the VoiceBank-DEMAND parity runbook (training and
                         sweep commands, overlay, BASELINE-format table)
make_pesq_validation_set the PESQ engine's MNRU/level/delay conformance
                         sweep and the deterministic degraded pairs

Each takes ``--device`` (default ``cuda``, raising on a host without a
card; ``cpu`` runs on the CPU) and ``main(argv=None)``.  Reports and
records are written under ``--root`` (``--output`` for the runbook,
``--out`` for the PESQ set) unless ``--report`` says otherwise, never
into the repository's ``docs/`` or test fixtures.
"""
