"""neuray_tpu_torch — the PyTorch / CUDA port of neuray_tpu.

The JAX package ``neuray_tpu`` stays the reference; this package renders
the same views with the same weights, trains the generalization model
and finetunes it on one scene, on an NVIDIA Hopper GPU. It imports torch
and never jax or flax.

Layout (mirrors ``neuray_tpu``):
    ops/        geometry, sampling, mixture-of-logistics, compositing,
                interpolation; ``ops/gather.py`` wraps the hand-written
                CUDA border gather in ``csrc/`` and its backward
    models/     nn.Modules: encoders, init net, dist decoder, IBRNet
                aggregation, the renderer (render and training forward),
                the finetuning model (``ft.py``)
    train/      losses, learning-rate schedules, metrics, the trainers
                (generalization and finetuning)
    data/       every dataset family of the JAX package and its
                training datasets (GeneralRendererDataset, the synthetic
                spheres), imgs_info, view selection, COLMAP's files,
                numpy copies of cv2's resizes, scenes fabricated on disk
    utils/      flat-npz weight loading, the flax <-> torch bridge, the
                image codecs (PNG, baseline JPEG), a YAML reader
    csrc/       CUDA C++ kernels for sm_90a and the C++ image codec,
                built at first use
    run_training.py   the training CLI (``python -m
                neuray_tpu_torch.run_training --cfg <yaml>``)
"""

__version__ = "0.1.0"
