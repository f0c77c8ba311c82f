"""Every public name of the JAX package is accounted for in the port.

The JAX sources are read with ``ast`` (no JAX backend is needed).  Each
name in the ``__all__`` of ``websplat_tpu`` and of each of its subpackages,
and each public top-level ``def`` and ``class`` of every
``websplat_tpu/**.py``, must be one of:

- exported by the port's same-named package (in its ``__all__``), or
  defined in the port's same-named module (``MODULE_FILES`` maps the JAX
  modules whose port file has another name);
- listed in ``COUNTERPARTS`` with the dotted paths of the port's
  counterparts, for a name whose contract differs: the test imports each
  path, so a stale entry fails;
- listed in ``NOT_PORTED`` (or its module in ``NOT_PORTED_MODULES``), with
  the reason from ROADMAP.md's "Not ported (removal)" list.

A name the JAX package gains fails here until it is ported or listed.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "websplat_tpu"
PORT = "websplat_tpu_torch"

# JAX modules whose port file has another name -> the port files
MODULE_FILES = {
    "ops/frontend_pallas.py": ("ops/frontend.py",),
    "ops/overflow_pallas.py": ("ops/overflow.py",),
    "ops/compact_pallas.py": ("ops/compact.py",),
    "ops/emit_compact_pallas.py": ("ops/emit_compact.py",),
    "ops/rasterize_pallas.py": ("ops/rasterize.py", "ops/rasterize_mxu.py"),
}

# JAX modules with no counterpart, and why (ROADMAP.md, "Not ported (removal)")
NOT_PORTED_MODULES = {
    "ops/rasterize_xla.py": "raster_backend='xla' and its xla_max_per_tile: the XLA fallback "
                            "rasterizer; the port's plain versions do the fallback's job",
    "utils/compile_cache.py": "utils/compile_cache.py: JAX's persistent compilation cache; "
                              "the port builds its kernels once per source hash "
                              "(kernels/build.py)",
}

# (JAX module, name) -> the port's counterparts, for names whose contract
# differs (dotted paths: module, then attributes)
COUNTERPARTS = {
    # returns None where the build fails; the port raises
    ("native/__init__.py", "get_lib"): ("websplat_tpu_torch.native.lib",),
    ("native/__init__.py", "decode_ply_native"): ("websplat_tpu_torch.native.decode_ply",),
    # two f16 or u16 halves of a word: the port packs them inside the codecs
    ("ops/packing.py", "pack2xf16"): ("websplat_tpu_torch.ops.packing.f32_to_f16_bits",),
    ("ops/packing.py", "unpack2xf16"): ("websplat_tpu_torch.ops.packing.f16_bits_to_f32",),
    ("ops/packing.py", "pack2xu16"): ("websplat_tpu_torch.ops.packing.pack_center",),
    ("ops/packing.py", "unpack2xu16"): ("websplat_tpu_torch.ops.packing.unpack_center",),
    # device pytrees of the camera and the settings: host floats, and one
    # (55,) f32 device tensor per frame
    ("ops/preprocess.py", "CameraParams"): ("websplat_tpu_torch.ops.preprocess.FrameScalars",
                                            "websplat_tpu_torch.render.renderer.frame_block"),
    ("ops/preprocess.py", "DeviceSettings"): ("websplat_tpu_torch.ops.preprocess.FrameScalars",
                                              "websplat_tpu_torch.render.renderer.frame_block"),
    ("ops/preprocess.py", "scalars_from_pytrees"): (
        "websplat_tpu_torch.ops.preprocess.FrameScalars.from_block",),
    ("render/renderer.py", "camera_to_device"): ("websplat_tpu_torch.render.renderer.camera_block",
                                                 "websplat_tpu_torch.render.renderer.frame_block"),
    ("render/renderer.py", "settings_to_device"): (
        "websplat_tpu_torch.render.renderer.camera_block",
        "websplat_tpu_torch.render.renderer.frame_block"),
    # the slot-instance stream: the frontend's output and the frame's stream
    ("ops/preprocess.py", "preprocess"): ("websplat_tpu_torch.render.renderer.frame_stream",
                                          "websplat_tpu_torch.ops.preprocess.preprocess_packed"),
    ("ops/preprocess.py", "PreprocessOut"): ("websplat_tpu_torch.ops.frontend.FrontendOut",
                                             "websplat_tpu_torch.render.renderer.FrameStream"),
    ("ops/preprocess.py", "PreprocessPacked"): ("websplat_tpu_torch.ops.preprocess.PackedOut",),
    ("ops/preprocess.py", "iter_slots"): ("websplat_tpu_torch.ops.preprocess.slot_tiles",),
    ("ops/preprocess.py", "reaches_of"): ("websplat_tpu_torch.ops.preprocess.make_reaches",),
    # the overflow pass off the TPU: the plain versions of the walk and the
    # dense stage
    ("ops/preprocess.py", "overflow_emit"): ("websplat_tpu_torch.ops.overflow.overflow_walk_torch",
                                             "websplat_tpu_torch.ops.compact.dense_compact_torch"),
    ("ops/rasterize_pallas.py", "rasterize_pallas"): (
        "websplat_tpu_torch.ops.rasterize.rasterize",
        "websplat_tpu_torch.ops.rasterize_mxu.rasterize_mxu"),
    ("render/renderer.py", "render_frame_impl"): ("websplat_tpu_torch.render.renderer.render_frame",),
    # JAX device meshes: torch.distributed groups
    ("parallel/multiview.py", "view_mesh"): ("websplat_tpu_torch.parallel.group.view_group",),
    ("parallel/sharded.py", "splat_mesh"): ("websplat_tpu_torch.parallel.group.splat_group",),
}

# (JAX module, name) -> why it is not ported (ROADMAP.md, "Not ported (removal)")
NOT_PORTED = {
    ("ops/frontend_pallas.py", "build_fat_stream"): "DeviceCloud.fat and build_fat_stream: the "
                                                    "TPU frontend's fat input stream",
    ("render/renderer.py", "use_pallas_ops"): "use_pallas_ops: the choice between Pallas and "
                                              "its interpret mode off the TPU; a tensor's device "
                                              "picks kernel or plain version here",
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _jax_packages():
    return sorted(str(p.parent.relative_to(JAX)) for p in JAX.rglob("__init__.py"))


def _tree(rel: str) -> ast.Module:
    return ast.parse((JAX / rel).read_text(), filename=rel)


def public_defs(rel: str):
    """Public top-level def and class names of a JAX module."""
    return [n.name for n in _tree(rel).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def package_exports(pkg: str):
    """(name, the JAX module it is imported from) of each name in a JAX
    package's ``__all__``."""
    rel = "__init__.py" if pkg == "." else f"{pkg}/__init__.py"
    tree = _tree(rel)
    names, origin = [], {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            names = ast.literal_eval(node.value)
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("websplat_tpu"):
            path = node.module.split(".")[1:]
            for a in node.names:
                origin[a.asname or a.name] = "/".join(path) + ".py"
    return [(n, origin.get(n, rel)) for n in names]


def port_module_name(rel: str) -> str:
    return ".".join([PORT, *rel[:-3].split("/")]).removesuffix(".__init__")


def resolve(dotted: str):
    """Import the longest module prefix of a dotted path, then walk its
    attributes; raises if any part is missing."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def listed(rel: str, name: str) -> bool:
    """Whether the tables account for a name; a counterpart must import."""
    if rel in NOT_PORTED_MODULES or (rel, name) in NOT_PORTED:
        return True
    if (rel, name) in COUNTERPARTS:
        for path in COUNTERPARTS[rel, name]:
            resolve(path)
        return True
    return False


@pytest.mark.parametrize("pkg", _jax_packages())
def test_package_exports(pkg):
    """Each name in a JAX package's __all__ is in the port package's
    __all__, or the tables account for it."""
    port = importlib.import_module(PORT if pkg == "." else f"{PORT}.{pkg.replace('/', '.')}")
    exported = getattr(port, "__all__", [])
    missing = [(name, rel) for name, rel in package_exports(pkg)
               if not (name in exported and hasattr(port, name)) and not listed(rel, name)]
    assert not missing, f"{port.__name__} does not account for {missing}"


@pytest.mark.parametrize("rel", [m for m in _jax_modules() if m not in NOT_PORTED_MODULES])
def test_module_names(rel):
    """Each public top-level def and class of a JAX module is defined in its
    port module (or modules), or the tables account for it."""
    names = public_defs(rel)
    mods = [importlib.import_module(port_module_name(p)) for p in MODULE_FILES.get(rel, (rel,))]
    missing = [n for n in names if not any(hasattr(m, n) for m in mods) and not listed(rel, n)]
    assert not missing, f"websplat_tpu/{rel}: no counterpart for {missing}"


def test_tables_name_jax_names():
    """Every table entry names a public def or class of a JAX module, none
    is listed twice, every mapped file exists, and no counterpart entry is
    for a name the port defines under the same name."""
    modules = set(_jax_modules())
    assert set(MODULE_FILES) <= modules and set(NOT_PORTED_MODULES) <= modules
    for rel, files in MODULE_FILES.items():
        assert not (ROOT / PORT / rel).exists()
        assert all((ROOT / PORT / f).is_file() for f in files)
    for rel in NOT_PORTED_MODULES:
        assert not (ROOT / PORT / rel).exists()
    assert not set(COUNTERPARTS) & set(NOT_PORTED)
    for rel, name in [*COUNTERPARTS, *NOT_PORTED]:
        assert name in public_defs(rel), (rel, name)
        mods = [importlib.import_module(port_module_name(p))
                for p in MODULE_FILES.get(rel, (rel,))]
        assert not any(hasattr(m, name) for m in mods), (rel, name)
    for reason in [*NOT_PORTED.values(), *NOT_PORTED_MODULES.values()]:
        assert reason

