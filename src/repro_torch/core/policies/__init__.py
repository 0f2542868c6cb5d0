"""Server-side collaboration policies. Importing this package registers
``sqmd``, the one policy this slice of the port carries."""
from repro_torch.core.policies.base import (ServerPolicy, as_policy,
                                            get_policy, is_registered,
                                            register_policy,
                                            registered_policies)
from repro_torch.core.policies.sqmd import SQMDPolicy

__all__ = ["ServerPolicy", "as_policy", "get_policy", "is_registered",
           "register_policy", "registered_policies", "SQMDPolicy"]
