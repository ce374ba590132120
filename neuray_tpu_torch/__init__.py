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
    data/       the synthetic sphere scene and training set, the
                NeRF-synthetic database, imgs_info, view selection,
                COLMAP's dense maps (numpy)
    utils/      flat-npz weight loading, the flax <-> torch bridge, PNG
    csrc/       CUDA C++ kernels for sm_90a, built at first use
"""

__version__ = "0.1.0"
