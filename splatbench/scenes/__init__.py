"""Scene kinds, one module per ``scene.kind`` of a configuration file,
loaded from the data directory by ``registry.scene_kind``.

Each module defines:

- ``make(scene: dict, seed: int, device) -> dict``: the raw inputs of one
  scene drawn from the seed, which the harness hands to the program and,
  unchanged, to the reference.  The draws run on ``device`` with a
  ``torch.Generator`` in a few large calls;
- ``program(inputs, config)``: the scene as the program loads it, a host
  ``GaussianCloud`` of ``websplat_tpu_torch`` (the one function that
  imports the port, inside it);
- ``reference(inputs, device) -> reference.Scene``: the reference's own
  decode of the raw inputs, which imports nothing of the port;
- ``centres(inputs, device) -> reference.Scene``: the splat centres alone,
  for the frustum counts behind the cull's headroom;
- ``codebook_bytes(scene: dict)``: what the decode layer's work reads
  besides its per-splat streams, or None where the program renders the
  rows as loaded (no decode layer; ``run.Ctx``).

A time-dependent kind adds, optionally:

- ``at(scene: reference.Scene, t: float) -> reference.Scene``: the
  reference scene at scene time ``t`` from the decoded one, asked once for
  each distinct time of the views a check renders (``check.py``);
- ``blocks(cameras, times, views, settings, background, device)``: the
  frame blocks of rows ``views`` of ``cameras`` (a ``CameraBatch``) at the
  scene times ``times`` (one a row of ``cameras``), for the pass and views
  loops (``drivers.py``); without it, ``parallel/multiview.view_blocks``.
"""
