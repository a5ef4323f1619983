"""The training loops (``train.loop``), loaded on first use of these names:
the solvers and kernels below them import ``train.profiler``, so the
package may not import the loop while it loads."""

__all__ = ["TrainLoop", "TrainReport", "train_model"]


def __getattr__(name):
    if name in __all__:
        from matfac_tpu_torch.train import loop
        return getattr(loop, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
