"""The port does everything the JAX package does: every public name of
`quantpy_tpu` has a twin in `quantpy_tpu_torch`.

The test walks every module of `quantpy_tpu` with `pkgutil.walk_packages`
(one case per module). For each public function, class, public method,
property and class attribute that a module defines (not one it imports), it
asserts a twin of the same name at the same module path of the port, and
for each callable twin every parameter name of the JAX signature. The port
may add parameters. A JAX parameter also matches its rename in
PARAM_RENAMES. Only a module that does not import is left out; its case
skips and says why.

What has no twin stands in ALLOWLIST with its reason, and a second test
fails if an allowlisted name gains a twin (or leaves the JAX package), so
the list cannot go stale. The two TPU kernels have twins under other names:
KERNEL_TWINS maps them.
"""

import importlib
import inspect
import pkgutil

import pytest

torch = pytest.importorskip("torch")

import quantpy_tpu  # noqa: E402

#: JAX parameter name -> the port's name for it (the JAX name also counts)
PARAM_RENAMES = {
    "key": "generator",  # the port draws from an explicit torch.Generator
    "a_l_pair": "a_l",  # complex tensors in place of re/im pairs
    "a_r_pair": "a_r",
}

#: names of the JAX package without a twin, each with its reason; a
#: parameter is written as function(parameter)
ALLOWLIST = {
    "ops.kernels.pallas_supported":
        "a Pallas/Mosaic capability probe; the port's kernel rule is "
        "state_core._use_rhor_kernel (float32 batches on CUDA)",
    "mhmc.MHMC.max_steps_per_call":
        "splits a fused chain scan under the TPU's ~60 s execution kill; the "
        "port's chain loop is eager and has no such limit",
    "mhmc.maximize_logpdf(chunk)":
        "the same split for the fused mode-seeking scan; the port's loop is eager",
}

#: the TPU kernels -> (the CUDA kernel's wrapper in the same module, JAX
#: parameters it does not take, with the reason)
KERNEL_TWINS = {
    "ops.kernels.rhor_mle_pallas": (
        "rhor_mle", {"block_b": "the Pallas grid's block; csrc/rhor_mle.cu fixes its tile"}),
    "ops.kernels.rhor_mle_pallas_flat": (
        "rhor_mle_flat",
        {"block_b": "the Pallas grid's block; csrc/rhor_mle_flat.cu fixes its tile"}),
}


def _walk():
    names, failed = ["quantpy_tpu"], []
    for info in pkgutil.walk_packages(quantpy_tpu.__path__, "quantpy_tpu.",
                                      onerror=failed.append):
        names.append(info.name)
    return names, failed


MODULES, WALK_FAILURES = _walk()


def _rel(module_name):
    return module_name[len("quantpy_tpu") + 1:]


def _port_name(module_name):
    return "quantpy_tpu_torch" + module_name[len("quantpy_tpu"):]


def _import(name):
    try:
        return importlib.import_module(name)
    except Exception as e:  # noqa: BLE001 - reported by the caller
        return e


def _parameters(obj):
    try:
        return list(inspect.signature(inspect.unwrap(obj)).parameters)
    except (TypeError, ValueError):  # builtins without a signature
        return None


def _missing_parameters(path, jax_obj, port_obj, dropped=()):
    want, have = _parameters(jax_obj), _parameters(port_obj)
    if want is None or have is None:
        return []
    return [f"{path}({p})" for p in want
            if p not in have and PARAM_RENAMES.get(p) not in have and p not in dropped]


def _defined_in(obj, module_name):
    return getattr(inspect.unwrap(obj), "__module__", None) == module_name


def _members(cls):
    """Public methods, properties and class attributes a class defines."""
    for name, member in vars(cls).items():
        if not name.startswith("_"):
            yield name, getattr(member, "__func__", member)


def _gaps(module_name, jax_mod, port_mod):
    """What the port lacks of `jax_mod`: names, and name(parameter)."""
    prefix = _rel(module_name)
    prefix = f"{prefix}." if prefix else ""
    for name, obj in vars(jax_mod).items():
        target = inspect.unwrap(obj)
        if name.startswith("_") or not (inspect.isfunction(target) or inspect.isclass(target)):
            continue
        if not _defined_in(obj, module_name):
            continue
        path = prefix + name
        twin_name, dropped = KERNEL_TWINS.get(path, (name, {}))
        twin = getattr(port_mod, twin_name, None)
        if twin is None:
            yield path
            continue
        yield from _missing_parameters(path, obj, twin, dropped)
        if inspect.isclass(target):
            for member_name, member in _members(target):
                member_path = f"{path}.{member_name}"
                if not hasattr(twin, member_name):
                    yield member_path
                elif callable(member) and not inspect.isclass(member):
                    yield from _missing_parameters(member_path, member,
                                                   getattr(twin, member_name))


def test_the_walk_reached_every_package():
    assert not WALK_FAILURES, f"quantpy_tpu packages that did not import: {WALK_FAILURES}"
    assert {"quantpy_tpu.ops.df32", "quantpy_tpu.tomography.kron_core",
            "quantpy_tpu.parallel.mesh"} <= set(MODULES)


@pytest.mark.parametrize("module_name", MODULES)
def test_module_has_its_twins(module_name):
    jax_mod = _import(module_name)
    if isinstance(jax_mod, Exception):
        pytest.skip(f"{module_name} does not import here: {jax_mod!r}")
    port_mod = importlib.import_module(_port_name(module_name))
    gaps = [g for g in _gaps(module_name, jax_mod, port_mod) if g not in ALLOWLIST]
    assert not gaps, f"{_port_name(module_name)} lacks twins of: {gaps}"


def _resolve(path):
    """(JAX object, port object or None, parameter or None) of an
    allowlist path."""
    param = None
    if path.endswith(")"):
        path, param = path[:-1].split("(")
    parts = path.split(".")
    for split in range(len(parts) - 1, 0, -1):
        module = ".".join(parts[:split])
        jax_mod = _import(f"quantpy_tpu.{module}")
        if not isinstance(jax_mod, Exception):
            break
    port_obj = importlib.import_module(f"quantpy_tpu_torch.{module}")
    jax_obj = jax_mod
    for attr in parts[split:]:
        jax_obj = getattr(jax_obj, attr)
        port_obj = getattr(port_obj, attr, None)
    return jax_obj, port_obj, param


@pytest.mark.parametrize("path", sorted(ALLOWLIST))
def test_allowlisted_names_have_no_twin(path):
    """An allowlisted name exists in the JAX package and has no twin in the
    port: once it gains one, it leaves the list."""
    jax_obj, port_obj, param = _resolve(path)
    if param is None:
        assert port_obj is None, f"{path} has a twin now: take it off ALLOWLIST"
    else:
        assert param in _parameters(jax_obj)
        assert param not in _parameters(port_obj), (
            f"{path} has a twin now: take it off ALLOWLIST")


@pytest.mark.parametrize("path", sorted(KERNEL_TWINS))
def test_kernel_twins_are_the_cuda_wrappers(path):
    from quantpy_tpu_torch.ops import kernels

    jax_obj, port_obj, _ = _resolve(path)
    twin_name, dropped = KERNEL_TWINS[path]
    assert port_obj is None, f"the port has {path} under its JAX name"
    twin = getattr(kernels, twin_name)
    assert hasattr(twin, "launches")  # a launch-counted kernel wrapper
    assert set(dropped) <= set(_parameters(jax_obj)) - set(_parameters(twin))
