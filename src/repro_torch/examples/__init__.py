"""The reference's five walkthroughs on the port's public API.

Each module has ``run(*, device=None, ...)``, which drives the
walkthrough at the reference's sizes (its keyword defaults) and returns
the numbers it prints, and ``main(argv=None)``, the reference script's
flags plus ``--device`` (default ``cuda``)::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.async_join
    PYTHONPATH=src python -m repro_torch.examples.train_and_serve
    PYTHONPATH=src python -m repro_torch.examples.train_sqmd_federation \\
        [--rounds 40] [--protocol sqmd|fedmd|ddist|isgd] [--resnet] \\
        [--ckpt runs/federation_ckpt]
    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        [--arch gemma3-1b] [--batch 4] [--prompt-len 48] [--decode 24] \\
        [--reduced | --no-reduced]

``device=None`` is the card, and raises without one. The report lines
come from small pure helpers on numpy arrays and ``History`` fields, so
the same helper reads a run of either package.
"""
