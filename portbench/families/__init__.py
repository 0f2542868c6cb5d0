"""Each model kind's adapter onto the port: the cohort builder the
engine takes, the benchmark's weights in the layout of the engine's
``init_params=`` seam, and its parameters and momentum read back under
the reference's leaf names."""
