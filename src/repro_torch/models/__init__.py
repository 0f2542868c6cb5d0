from repro_torch.models.common import ModelConfig, StackedCohort
from repro_torch.models.mlp import (CohortMLP, MLPConfig, hetero_mlp_zoo,
                                    mlp_family)
from repro_torch.models.resnet import (RESNET8, RESNET20, RESNET50,
                                       ResNet1DConfig, resnet1d_family)
from repro_torch.models.zoo import (DEFAULT_ZOO, FamilySpec, Zoo, as_family,
                                    build_zoo, get_family, parse_assignment,
                                    register_family, registered_families)

__all__ = ["CohortMLP", "MLPConfig", "ModelConfig", "RESNET8", "RESNET20",
           "RESNET50", "ResNet1DConfig", "StackedCohort", "DEFAULT_ZOO",
           "FamilySpec", "Zoo", "as_family", "build_zoo", "get_family",
           "hetero_mlp_zoo", "mlp_family", "parse_assignment",
           "register_family", "registered_families", "resnet1d_family"]
