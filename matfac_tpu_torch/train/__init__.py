from matfac_tpu_torch.train.loop import TrainLoop, TrainReport, train_model

__all__ = ["TrainLoop", "TrainReport", "train_model"]
