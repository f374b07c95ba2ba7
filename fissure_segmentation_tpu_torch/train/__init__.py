from .trainer import ModelTrainer, PlateauScheduler, TrainConfig  # noqa: F401
