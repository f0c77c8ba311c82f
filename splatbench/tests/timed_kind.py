"""A time-dependent scene kind for the tests (copied to
``scenes/timed_cloud.py`` of a test's data directory, with ``CALLS`` set to
a file): the cloud kind, with an ``at`` and a ``blocks`` that note each
call in ``CALLS`` and change nothing (the scene is the same at every time,
the blocks are ``view_blocks``'s)."""

from splatbench.scenes.cloud import centres, codebook_bytes, make, program, reference  # noqa: F401

CALLS = None


def _note(*words) -> None:
    with open(CALLS, "a") as f:
        f.write(" ".join(words) + "\n")


def at(scene, t: float):
    _note("at", repr(float(t)))
    return scene


def blocks(cameras, times, views, settings, background, device):
    from websplat_tpu_torch.parallel import multiview

    _note("blocks", *(repr(float(times[i])) for i in views))
    return multiview.view_blocks(cameras, views, settings, background, device)
