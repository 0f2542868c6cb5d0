from repro_torch.optim.optimizers import SGDState, Optimizer, sgd

__all__ = ["SGDState", "Optimizer", "sgd"]
