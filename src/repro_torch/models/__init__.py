from repro_torch.models.mlp import CohortMLP, MLPConfig, hetero_mlp_zoo

__all__ = ["CohortMLP", "MLPConfig", "hetero_mlp_zoo"]
