"""Server-side collaboration policies. Importing this package registers
the paper's four protocols (§IV-A): ``sqmd``, ``fedmd``, ``ddist`` and
``isgd``."""
from repro_torch.core.policies.base import (ServerPolicy, as_policy,
                                            get_policy, is_registered,
                                            register_policy,
                                            registered_policies,
                                            unregister_policy)
from repro_torch.core.policies.ddist import DDistPolicy
from repro_torch.core.policies.fedmd import FedMDPolicy
from repro_torch.core.policies.isgd import ISGDPolicy
from repro_torch.core.policies.sqmd import SQMDPolicy

__all__ = ["ServerPolicy", "as_policy", "get_policy", "is_registered",
           "register_policy", "registered_policies", "unregister_policy",
           "SQMDPolicy", "FedMDPolicy", "DDistPolicy", "ISGDPolicy"]
