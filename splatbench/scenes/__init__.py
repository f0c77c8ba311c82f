"""Scene generators, one module per ``scene.kind`` of a configuration file.

Each module has ``make(scene: dict, seed: int, device) -> dict``: the raw
inputs of one scene drawn from the seed, which the harness hands to the
program (``drivers.py``) and, unchanged, to the reference
(``reference.py``).  The draws run on ``device`` with a ``torch.Generator``
in a few large calls.
"""
