"""The port's public surface against the JAX package's, module by module.

Every ``.py`` module of ``audio_modem_radio_tpu`` has a counterpart of the
same dotted name in ``audio_modem_radio_tpu_torch`` (``ops/pallas_kernels``
is the port's ``ops/kernels``; ``utils/jaxenv``, which steers JAX's
platform choice, has none). For every public function or class a JAX
module defines, the port module has the same name, and the JAX parameter
names are a subset of the port's, but for the entries of ``_ALLOWED``,
each with its reason. Only signatures are read: nothing runs.
"""

import importlib
import inspect
import pkgutil

import pytest
import torch

import audio_modem_radio_tpu as jax_pkg

# Parallel test workers share the cores: one intra-op thread each keeps
# torch from oversubscribing them.
torch.set_num_threads(1)

_JAX, _PORT = "audio_modem_radio_tpu", "audio_modem_radio_tpu_torch"
_RENAMED = {"ops.pallas_kernels": "ops.kernels"}
_NO_COUNTERPART = {"utils.jaxenv"}

_PALLAS = "Pallas and TPU tiling only: the CUDA kernels take no interpret mode and tile themselves"
_FLAX = "flax's module bookkeeping; torch.nn modules have no name or parent"
# (module, name) -> {JAX parameter the port lacks: why}.
_ALLOWED = {
    **{("ops.pallas_kernels", fn): {"interpret": _PALLAS} for fn in (
        "psk_project_diff_batch", "psk_project_diff", "psk_project_decide_batch", "fsk_disc_sums_batch",
        "fsk_quad_margin_batch", "relabel_pack_batch", "bit_select_pack_batch", "rotation_match_batch",
        "sector_match_batch", "psk8_relabel_pack_rows")},
    **{("ops.pallas_kernels", fn): {"interpret": _PALLAS, "block_rows": _PALLAS} for fn in (
        "fsk_project_bits_batch", "fsk_tile_bits_batch")},
    ("ops.pallas_kernels", "neural_extract_batch"): {
        "interpret": _PALLAS,
        **{p: "K10's TPU layout inputs: the port takes the (256, 16) codebook and derives the rest"
           for p in ("chip_table", "codebook_blocked", "nrow", "spr")},
    },
    **{("models.neural_modem", cls): {"name": _FLAX, "parent": _FLAX}
       for cls in ("ModemEncoder", "ModemDecoder", "LearnedModem")},
    ("models.neural_modem", "create_train_state"): {
        "rng": "torch idiom: an integer seed for a torch.Generator in place of a JAX key"},
    ("models.neural_modem", "make_train_step"): {
        "tx": "torch idiom: a torch.optim optimizer (opt) in place of an optax transform"},
    **{("parallel.batch", fn): {"interpret": _PALLAS} for fn in (
        "psk4_kernel_sync_tail", "psk2_kernel_sync_tail", "psk8_kernel_sync_tail")},
}


def _jax_modules():
    names = [m.name[len(_JAX) + 1:] for m in pkgutil.walk_packages(jax_pkg.__path__, _JAX + ".")]
    return sorted(n for n in names if n not in _NO_COUNTERPART)


def _public(module):
    """{name: object} of the public functions and classes ``module`` defines
    (unwrapping ``jax.jit`` and ``lru_cache``)."""
    out = {}
    for name, obj in vars(module).items():
        if name.startswith("_"):
            continue
        base = inspect.unwrap(obj) if callable(obj) else obj
        if (inspect.isfunction(base) or inspect.isclass(obj)) and base.__module__ == module.__name__:
            out[name] = obj
    return out


def _params(obj):
    return list(inspect.signature(obj).parameters)


_MODULES = _jax_modules()


@pytest.mark.parametrize("name", _MODULES)
def test_module_surface_is_ported(name):
    jm = importlib.import_module(f"{_JAX}.{name}")
    pm = importlib.import_module(f"{_PORT}.{_RENAMED.get(name, name)}")
    missing, lacking = [], {}
    for fn, obj in _public(jm).items():
        if not hasattr(pm, fn):
            missing.append(fn)
            continue
        allowed = _ALLOWED.get((name, fn), {})
        port_params = set(_params(getattr(pm, fn)))
        gap = [p for p in _params(obj) if p not in port_params and p not in allowed]
        if gap:
            lacking[fn] = gap
    assert not missing, f"{name}: the port lacks {missing}"
    assert not lacking, f"{name}: the port lacks parameters {lacking}"


def test_module_list_is_whole():
    """Every JAX module is walked and maps to an importable port module."""
    assert {"ops.pallas_kernels", "ops.psk", "ops.fsk", "ops.common", "ops.neural", "parallel.batch",
            "models.neural_modem", "decoder", "cli"} <= set(_MODULES)
    assert "utils.jaxenv" not in _MODULES


@pytest.mark.parametrize("key", sorted(_ALLOWED))
def test_allowed_entry_is_still_needed(key):
    """Each allow-list entry names a JAX parameter that the port really
    lacks, so the list holds nothing that a port change made stale."""
    name, fn = key
    jm = importlib.import_module(f"{_JAX}.{name}")
    pm = importlib.import_module(f"{_PORT}.{_RENAMED.get(name, name)}")
    jax_params, port_params = set(_params(getattr(jm, fn))), set(_params(getattr(pm, fn)))
    for p, why in _ALLOWED[key].items():
        assert why
        assert p in jax_params and p not in port_params, (key, p)
