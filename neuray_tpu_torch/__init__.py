"""neuray_tpu_torch — the PyTorch / CUDA port of neuray_tpu.

The JAX package ``neuray_tpu`` stays the reference; this package renders
the same views with the same weights, and trains the generalization
model, on an NVIDIA Hopper GPU. It imports torch and never jax or flax.

Layout (mirrors ``neuray_tpu``):
    ops/        geometry, sampling, mixture-of-logistics, compositing,
                interpolation; ``ops/gather.py`` wraps the hand-written
                CUDA border gather in ``csrc/`` and its backward
    models/     nn.Modules: encoders, init net, dist decoder, IBRNet
                aggregation, the renderer (render and training forward)
    train/      losses, learning-rate schedules, metrics, the trainer
    data/       the synthetic sphere scene and training set (numpy)
    utils/      flat-npz weight loading, the flax <-> torch bridge
    csrc/       CUDA C++ kernels for sm_90a, built at first use
"""

__version__ = "0.1.0"
