"""The port's public surface against the JAX package's, module by module.

Every ``.py`` module of ``audio_modem_radio_tpu`` has a counterpart of the
same dotted name in ``audio_modem_radio_tpu_torch`` (``ops/pallas_kernels``
is the port's ``ops/kernels``; ``utils/jaxenv``, which steers JAX's
platform choice, has none). For every public function or class a JAX
module defines, the port module has the same name, and the JAX parameter
names are a subset of the port's, but for the entries of ``_ALLOWED``,
each with its reason. Only signatures are read: nothing runs.

Beside the functions, every public name of a JAX module that is neither a
module nor callable exists in the port module, equal where it is plain data
(numbers, strings, bytes and tuples, lists and dicts of them; a dict of
other values has the same keys), but for ``_ALLOWED_CONSTANTS``; and every
flax module, dataclass and namedtuple of the JAX package has its fields as
attributes of a default instance of the port's class, equal where plain
(``_RECORDS``).
"""

import __future__
import dataclasses
import importlib
import inspect
import pkgutil
import types

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


# (module, name) -> why the port's value differs from the JAX module's, or
# why the port lacks the name.
_ALLOWED_CONSTANTS = {
    ("models.train_neural", "DEFAULT_CODEBOOK"): "the path of the port's own shipped codebook file",
    ("observability", "LOGGER_NAME"): "the port's own logger, beside the JAX package's",
    ("models.neural_modem", "FLAX_AVAILABLE"): "whether flax imports; the port's modules are torch.nn",
}
# The JAX package's flax modules, dataclasses and namedtuples: (module, class)
# -> None where a default instance of each class is compared, else why none
# is built (the port's dataclass fields are read instead).
_NEEDS_ARGUMENTS = "its constructor needs arguments"
_RECORDS = {
    ("framing", "Frame"): _NEEDS_ARGUMENTS,
    ("framing", "FrameCandidate"): _NEEDS_ARGUMENTS,
    ("modem", "ModeSpec"): _NEEDS_ARGUMENTS,
    ("models.neural_modem", "ModemEncoder"): None,
    ("models.neural_modem", "ModemDecoder"): None,
    ("models.neural_modem", "LearnedModem"): None,
    ("tui", "AppState"): None,
}
_FLAX_BOOKKEEPING = ("parent", "name")


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


def _plain(v) -> bool:
    """Whether ``v`` is plain data: a number, string, bytes or None, or a
    tuple, list or dict of plain data."""
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return True
    if isinstance(v, (tuple, list)):
        return all(_plain(e) for e in v)
    if isinstance(v, dict):
        return all(_plain(k) and _plain(e) for k, e in v.items())
    return False


def _constant_gaps(name):
    """{public non-callable name of JAX module ``name``: what the port's
    module lacks or holds otherwise}."""
    jm = importlib.import_module(f"{_JAX}.{name}")
    pm = importlib.import_module(f"{_PORT}.{_RENAMED.get(name, name)}")
    gaps = {}
    for key, value in vars(jm).items():
        if key.startswith("_") or isinstance(value, (types.ModuleType, __future__._Feature)) or callable(value):
            continue
        if not hasattr(pm, key):
            gaps[key] = "missing"
            continue
        port = getattr(pm, key)
        if _plain(value) and port != value:
            gaps[key] = f"{port!r} != {value!r}"
        elif isinstance(value, dict) and not _plain(value) and set(port) != set(value):
            gaps[key] = f"keys {sorted(port)} != {sorted(value)}"
    return gaps


@pytest.mark.parametrize("name", _MODULES)
def test_module_constants_are_ported(name):
    """Each public non-callable name of the JAX module exists in the port
    module, equal where it is plain data, but for ``_ALLOWED_CONSTANTS``."""
    gaps = {k: v for k, v in _constant_gaps(name).items() if (name, k) not in _ALLOWED_CONSTANTS}
    assert not gaps, f"{name}: {gaps}"


@pytest.mark.parametrize("key", sorted(_ALLOWED_CONSTANTS), ids=lambda k: ".".join(k))
def test_allowed_constant_is_still_needed(key):
    """Each ``_ALLOWED_CONSTANTS`` entry names a constant that the port
    really lacks or holds otherwise."""
    name, const = key
    assert _ALLOWED_CONSTANTS[key]
    assert const in _constant_gaps(name), key


def _record_fields(cls):
    if issubclass(cls, tuple) and hasattr(cls, "_fields"):
        return list(cls._fields)
    return [f.name for f in dataclasses.fields(cls) if f.name not in _FLAX_BOOKKEEPING]


def test_record_list_is_whole():
    """``_RECORDS`` names every public flax module, dataclass and
    namedtuple of the JAX package."""
    import flax.linen as fnn

    found = set()
    for name in _MODULES:
        for cls_name, obj in _public(importlib.import_module(f"{_JAX}.{name}")).items():
            if inspect.isclass(obj) and (issubclass(obj, fnn.Module) or dataclasses.is_dataclass(obj)
                                         or (issubclass(obj, tuple) and hasattr(obj, "_fields"))):
                found.add((name, cls_name))
    assert found == set(_RECORDS)


@pytest.mark.parametrize("key", sorted(_RECORDS), ids=lambda k: ".".join(k))
def test_record_fields_are_attributes(key):
    """The JAX class's fields are attributes of a default instance of the
    port's class, equal where plain; for a class whose constructor needs
    arguments, fields of the port's dataclass."""
    name, cls_name = key
    jcls = getattr(importlib.import_module(f"{_JAX}.{name}"), cls_name)
    pcls = getattr(importlib.import_module(f"{_PORT}.{_RENAMED.get(name, name)}"), cls_name)
    fields = _record_fields(jcls)
    assert fields
    if _RECORDS[key] is not None:
        assert set(fields) <= set(_record_fields(pcls)), key
        return
    jobj, pobj = jcls(), pcls()
    for f in fields:
        assert hasattr(pobj, f), (key, f)
        if _plain(getattr(jobj, f)):
            assert getattr(pobj, f) == getattr(jobj, f), (key, f)


def test_learned_modem_keeps_its_configuration():
    """The learned modem's classes keep their configuration as the flax
    modules do, and the module its sample rate."""
    from audio_modem_radio_tpu_torch.models import neural_modem
    from audio_modem_radio_tpu_torch.parallel import sequence

    assert neural_modem.LearnedModem(hidden=64).hidden == 64
    assert neural_modem.ModemEncoder().samples_per_symbol == 8
    dec = neural_modem.ModemDecoder(hidden=32, n_symbols=16)
    assert (dec.hidden, dec.n_symbols) == (32, 16)
    assert neural_modem.SAMPLE_RATE == 96000
    assert sequence.DATA_AXIS == "data"
