from repro_torch.configs.registry import (ARCH_IDS, INPUT_SHAPES,
                                          LONG_CONTEXT_OK, InputShape,
                                          concrete_inputs, get_config,
                                          get_reduced, input_specs,
                                          skip_reason, supports_shape)

__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "LONG_CONTEXT_OK", "InputShape",
    "concrete_inputs", "get_config", "get_reduced", "input_specs",
    "skip_reason", "supports_shape",
]
