"""Checkpoint ingestion and the port's native format (port of
flashmd_tpu/models/checkpoint_io.py).

The reference ships trained models as ``model_and_prior.pt``, a pickled
module tree ``GradientsOut(SumOut({SchNet, priors...}))``, and starting
structures as pickled lists of PyG ``AtomicData``. Both are read here
without the reference package or torch_geometric: a permissive unpickler
makes a stub class for every symbol it cannot import (torch rebuilds the
tensors), and the weights and buffers are walked out of the stub tree:

* ``load_reference_checkpoint`` -> :class:`ReferenceModel` (numpy weights,
  dense type tables, the port's ``SchNetConfig``);
* ``load_reference_configurations`` -> list of ``Configuration``;
* ``build_forcefield`` binds a ReferenceModel to one molecule: the
  per-term prior parameters, the message-passing path (the Chebyshev path
  with its measured frontier by default, models/frontier.py), the
  neighbour capacity; tensors on the card unless ``device`` says
  otherwise;
* ``save_native_model`` / ``load_native_model`` and the configuration
  pair: the port's own format, a pickle of plain dicts of numpy arrays.
  The loaders also read the JAX package's native files (its pickled
  ``ForceField`` / ``ReferenceModel``, its ``Configuration`` lists, its
  specialized dump) without importing it: each of its classes is read as
  its pickled state and rebuilt as the port's counterpart.

Unpickling a reference checkpoint runs whatever the file says, as
``torch.load(weights_only=False)`` does for the reference itself: load
only files from a source you trust. The native loaders accept numpy
arrays, builtin containers and the two packages' model and structure
classes only, and refuse any other global by name.

torch ``Linear`` stores ``[out, in]``; the port's MLPs take ``[in, out]``,
transposed here once.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.system import Configuration, TermList, make_term_list
from ..ops.neighborlist import max_neighbor_count, suggest_capacity
from ..prior.priors import (
    _KIND_FEATURES,
    HARMONIC_KINDS,
    Prior,
    densify_repulsion,
    gather_type_params,
)
from .convert import _tree_to_torch, config_from_kwargs
from .cutoff import CosineCutoff, IdentityCutoff, ShiftedCosineCutoff
from .forcefield import ForceField
from .radial_basis import GaussianBasisConfig
from .schnet import SchNetConfig

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Permissive unpickling (reference checkpoint_io.py:53-117)
# ---------------------------------------------------------------------------

_STUB_CACHE: Dict[tuple, type] = {}


class _Stub:
    """Generic stand-in for an unimportable pickled class."""

    def __init__(self, *args, **kwargs):
        self._stub_args = args
        self._stub_kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)
        else:
            self.__dict__["_stub_state"] = state

    def __repr__(self):
        cls = type(self)
        return f"<stub {cls.__stub_module__}.{cls.__name__}>"


def _make_stub(module: str, name: str) -> type:
    key = (module, name)
    if key not in _STUB_CACHE:
        _STUB_CACHE[key] = type(name, (_Stub,), {"__stub_module__": module})
    return _STUB_CACHE[key]


class _ShimUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _make_stub(module, name)


class _ShimPickleModule:
    """The pickle-module facade that ``torch.load(pickle_module=...)``
    takes."""

    Unpickler = _ShimUnpickler
    load = staticmethod(pickle.load)

    @staticmethod
    def loads(data, **kwargs):
        return _ShimUnpickler(io.BytesIO(data), **kwargs).load()


def _torch_load_with_stubs(path: str):
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_ShimPickleModule)


# ---------------------------------------------------------------------------
# Stub-tree traversal (reference checkpoint_io.py:119-225)
# ---------------------------------------------------------------------------


def _class_name(obj) -> str:
    return type(obj).__name__


def _children(mod) -> Dict[str, Any]:
    """Child modules of a torch module or stub."""
    d = getattr(mod, "_modules", None)
    return dict(d) if d else {}


def _attr(mod, name, default=None):
    """Attribute lookup across __dict__, _parameters, _buffers, _modules."""
    if mod is None:
        return default
    d = getattr(mod, "__dict__", {})
    if name in d:
        return d[name]
    for source in ("_parameters", "_buffers", "_modules"):
        d = getattr(mod, source, None)
        if d and name in d:
            return d[name]
    return getattr(mod, name, default)


def _np(tensor) -> Optional[np.ndarray]:
    """torch tensor (sparse ones densified) -> numpy."""
    if tensor is None:
        return None
    if isinstance(tensor, np.ndarray):
        return tensor
    t = tensor.detach()
    if t.is_sparse:
        t = t.to_dense()
    return t.cpu().numpy()


def _linear_np(linear) -> Dict[str, np.ndarray]:
    """torch Linear -> {'w' [in, out], 'b' [out]?}."""
    out = {"w": _np(_attr(linear, "weight")).T.copy()}
    b = _attr(linear, "bias")
    if b is not None:
        out["b"] = _np(b)
    return out


def _mlp_np(mlp) -> Dict[str, list]:
    """Reference MLP (``.layers`` Sequential of Linear/activation)."""
    layers = [_linear_np(child)
              for child in _children(_attr(mlp, "layers")).values()
              if _attr(child, "weight") is not None]
    return {"layers": layers}


def _output_network_np(mod):
    """A plain MLP head, or a TypesMLP (reference mlp.py:60-121): a
    shared-weights one collapses to its MLP, a per-species one becomes the
    ``{"species", "mlps"}`` bank of ``types_mlp_apply``."""
    if _class_name(mod) == "TypesMLP":
        inner = _attr(mod, "mlp")
        species = _attr(mod, "species")
        if species is None:
            return _mlp_np(inner)
        return {"species": _np(species).astype(np.int32),
                "mlps": [_mlp_np(m) for m in _children(inner).values()]}
    return _mlp_np(mod)


def _output_first_mlp(output: dict) -> dict:
    return output["mlps"][0] if "mlps" in output else output


def _activation_name(mlp) -> str:
    for child in _children(_attr(mlp, "layers")).values():
        name = _class_name(child).lower()
        if name in ("tanh", "relu", "silu"):
            return name
    return "tanh"


def _cutoff_from(cutoff_mod):
    name = _class_name(cutoff_mod)
    lower = float(_attr(cutoff_mod, "cutoff_lower", 0.0) or 0.0)
    upper = float(_attr(cutoff_mod, "cutoff_upper", 5.0))
    if name == "IdentityCutoff":
        return IdentityCutoff(lower, upper)
    if name == "ShiftedCosineCutoff":
        return ShiftedCosineCutoff(
            cutoff_upper=upper,
            smooth_width=float(_attr(cutoff_mod, "smooth_width", 0.5)),
        )
    return CosineCutoff(lower, upper)


# ---------------------------------------------------------------------------
# The torch-free model (reference checkpoint_io.py:226-440)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReferencePrior:
    """A reference prior with dense type-indexed parameter tables."""

    kind: str
    name: str
    tables: Dict[str, np.ndarray]
    order: int
    n_degs: int = 0


@dataclasses.dataclass
class ReferenceModel:
    """A model_and_prior.pt checkpoint in numpy: SchNet weights in the
    port's layout, its config (message passing "xla", the reference's
    default, until ``build_forcefield`` chooses), and the priors."""

    schnet_params: Optional[dict]
    schnet_config: Optional[SchNetConfig]
    priors: List[ReferencePrior]


_PRIOR_CLASS_TO_KIND = {
    "HarmonicBonds": "harmonic_bonds",
    "HarmonicAngles": "harmonic_angles",
    "HarmonicAnglesRaw": "harmonic_angles_raw",
    "HarmonicImpropers": "harmonic_impropers",
    "ShiftedPeriodicHarmonicImpropers": "shifted_periodic_harmonic_impropers",
    "GeneralBonds": "general_bonds",
    "GeneralAngles": "general_angles",
    "Repulsion": "repulsion",
    "Dihedral": "dihedral",
    "FourierSeries": "dihedral",
    "Polynomial": "polynomial",
    "QuarticAngles": "quartic_angles",
    "RestrictedQuartic": "restricted_quartic",
}

_DEFAULT_ORDER = {
    "harmonic_bonds": 2,
    "harmonic_angles": 3,
    "harmonic_angles_raw": 3,
    "harmonic_impropers": 4,
    "shifted_periodic_harmonic_impropers": 4,
    "general_bonds": 2,
    "general_angles": 3,
    "repulsion": 2,
    "dihedral": 4,
    "polynomial": 3,
    "quartic_angles": 3,
    "restricted_quartic": 3,
}

# kind -> the type tables its reference module holds
_PRIOR_TABLES = {
    **{kind: ("x_0", "k") for kind in HARMONIC_KINDS},
    "repulsion": ("sigma",),
    "dihedral": ("k1s", "k2s", "v_0"),
    "polynomial": ("ks", "v_0"),
    "quartic_angles": ("ks", "v_0"),
    "restricted_quartic": ("a", "b", "c", "d", "k", "v_0"),
}


def _unwrap_output_wrappers(mod):
    """GradientsOut(X) / EnergyOut(X) -> X, recursively: both hold the
    wrapped module as ``.model`` and only route outputs."""
    while _class_name(mod) in ("GradientsOut", "EnergyOut"):
        mod = _attr(mod, "model")
    return mod


def _extract_schnet(schnet) -> tuple:
    """Stub SchNet -> (numpy params, SchNetConfig)."""
    embedding = _np(_attr(_attr(schnet, "embedding_layer"), "weight"))
    rbf_layer = _attr(schnet, "rbf_layer")
    offset = _np(_attr(rbf_layer, "offset"))
    coeff = _np(_attr(rbf_layer, "coeff"))
    rbf_cutoff = _cutoff_from(_attr(rbf_layer, "cutoff"))

    interactions = []
    conv_cutoff = rbf_cutoff
    filter_act = "tanh"
    for block in _children(_attr(schnet, "interaction_blocks")).values():
        conv = _attr(block, "conv")
        conv_cutoff = _cutoff_from(_attr(conv, "cutoff"))
        filt = _attr(conv, "filter_network")
        filter_act = _activation_name(filt)
        lin1 = _linear_np(_attr(conv, "lin1"))
        lin2 = _linear_np(_attr(conv, "lin2"))
        lin = _linear_np(_attr(block, "lin"))
        interactions.append({
            "lin1_w": lin1["w"],
            "filter": _mlp_np(filt),
            "lin2_w": lin2["w"],
            "lin2_b": lin2.get("b",
                               np.zeros(lin2["w"].shape[1], np.float32)),
            "lin_w": lin["w"],
            "lin_b": lin.get("b", np.zeros(lin["w"].shape[1], np.float32)),
        })

    output = _output_network_np(_attr(schnet, "output_network"))
    params = {
        "embedding": embedding,
        "rbf": {"offset": offset, "coeff": coeff},
        "interactions": interactions,
        "output": output,
    }
    config = SchNetConfig(
        hidden_channels=embedding.shape[1],
        embedding_size=embedding.shape[0],
        num_filters=interactions[0]["lin1_w"].shape[1],
        num_interactions=len(interactions),
        num_rbf=offset.shape[0],
        cutoff=conv_cutoff,
        rbf_cutoff=rbf_cutoff,
        output_hidden_layer_widths=tuple(
            layer["w"].shape[1]
            for layer in _output_first_mlp(output)["layers"][:-1]
        ),
        activation=filter_act,
        max_num_neighbors=int(_attr(schnet, "max_num_neighbors", 1000)),
        message_passing="xla",
    )
    return params, config


def _extract_prior(name: str, prior) -> Optional[ReferencePrior]:
    cls = _class_name(prior)
    kind = _PRIOR_CLASS_TO_KIND.get(cls)
    if kind is None:
        logger.warning(f"Unknown prior class {cls!r} for model entry "
                       f"{name!r}; skipped.")
        return None
    return ReferencePrior(
        kind=kind,
        name=str(_attr(prior, "name", name)),
        tables={f: _np(_attr(prior, f)) for f in _PRIOR_TABLES[kind]},
        order=int(_attr(prior, "order", _DEFAULT_ORDER[kind])),
        n_degs=int(_attr(prior, "n_degs", 0) or 0),
    )


def extract_reference_model(root,
                            allow_unconvertible: bool = False
                            ) -> ReferenceModel:
    """Walk an unpickled (stubbed) module tree into a ReferenceModel
    (the contract GradientsOut(SumOut({name: model})); EnergyOut entries
    unwrap like GradientsOut). An entry that cannot be converted is an
    error, since dropping a prior changes the physics;
    ``allow_unconvertible=True`` warns and skips it instead."""
    root = _unwrap_output_wrappers(root)
    schnet_params = schnet_config = None
    priors: List[ReferencePrior] = []

    def handle_prior(name, entry):
        p = _extract_prior(name, entry)
        if p is not None:
            priors.append(p)
        elif not allow_unconvertible:
            raise ValueError(
                f"Checkpoint entry {name!r} (class {_class_name(entry)!r}) "
                "is not convertible; refusing to silently drop physics. "
                "Pass allow_unconvertible=True to skip it explicitly."
            )

    if _class_name(root) == "SumOut":
        for name, entry in _children(_attr(root, "models")).items():
            entry = _unwrap_output_wrappers(entry)
            if _class_name(entry) in ("SchNet", "StandardSchNet"):
                schnet_params, schnet_config = _extract_schnet(entry)
            else:
                handle_prior(name, entry)
    elif _class_name(root) in ("SchNet", "StandardSchNet"):
        schnet_params, schnet_config = _extract_schnet(root)
    else:
        handle_prior(_class_name(root), root)
    return ReferenceModel(schnet_params=schnet_params,
                          schnet_config=schnet_config, priors=priors)


def load_reference_checkpoint(path: str, allow_unconvertible: bool = False
                              ) -> ReferenceModel:
    """model_and_prior.pt -> ReferenceModel. A
    ``<name>_specialized_model_and_config.pt`` holds a (model,
    configurations) tuple; its model is read."""
    root = _torch_load_with_stubs(path)
    if isinstance(root, tuple):
        root = root[0]
    return extract_reference_model(root,
                                   allow_unconvertible=allow_unconvertible)


# ---------------------------------------------------------------------------
# Structures (reference checkpoint_io.py:463-535)
# ---------------------------------------------------------------------------


def _find_mapping_dict(obj, depth: int = 0) -> Optional[dict]:
    """The field dict of a pickled PyG Data object (its storage
    ``_mapping``), searched for in the stub graph."""
    if depth > 4 or obj is None:
        return None
    if isinstance(obj, dict):
        if "pos" in obj and "atom_types" in obj:
            return obj
        for v in obj.values():
            found = _find_mapping_dict(v, depth + 1)
            if found is not None:
                return found
        return None
    d = getattr(obj, "__dict__", None)
    return None if d is None else _find_mapping_dict(d, depth + 1)


def _term_lists_from_reference_nl(nl_dict) -> Dict[str, TermList]:
    """The reference's neighbour-list dicts -> TermLists."""
    out = {}
    for name, nl in (nl_dict or {}).items():
        index_mapping = _np(nl["index_mapping"])
        rcut = nl.get("rcut")
        out[name] = make_term_list(
            index_mapping,
            tag=str(nl.get("tag", name)),
            order=int(nl.get("order", index_mapping.shape[0])),
            rcut=None if rcut is None else float(rcut),
            self_interaction=bool(nl.get("self_interaction") or False),
        )
    return out


def load_reference_configurations(path: str) -> List[Configuration]:
    """Pickled List[AtomicData] -> List[Configuration], with the
    structure's pair exclusions (``exc_pair_index``) where it has them."""
    raw = _torch_load_with_stubs(path)
    if not isinstance(raw, (list, tuple)):
        raw = [raw]
    configs = []
    for item in raw:
        mapping = _find_mapping_dict(item)
        if mapping is None:
            raise ValueError(
                f"Could not locate AtomicData fields in {type(item)!r}"
            )
        configs.append(Configuration(
            pos=_np(mapping["pos"]),
            atom_types=_np(mapping["atom_types"]).astype(np.int64),
            masses=_np(mapping.get("masses")),
            velocities=_np(mapping.get("velocities")),
            neighbor_lists=_term_lists_from_reference_nl(
                mapping.get("neighbor_list")),
            exc_pair_index=_np(mapping.get("exc_pair_index")),
            tag=str(mapping.get("tag", "")),
        ))
    return configs


# ---------------------------------------------------------------------------
# ReferenceModel + molecule -> ForceField (reference
# checkpoint_io.py:538-761)
# ---------------------------------------------------------------------------


def build_prior(ref_prior: ReferencePrior, atom_types, term_list: TermList,
                device="cuda", dtype=torch.float32) -> Prior:
    """The dense-table prior specialised onto one molecule: each term's
    parameters gathered from the type tables once."""
    idx = np.asarray(term_list.index_mapping, dtype=np.int64)
    t = ref_prior.tables
    kind = ref_prior.kind

    def gather(table):
        return gather_type_params(table, atom_types, idx)

    if kind == "dihedral":
        n = t["k1s"].shape[0]
        params = {
            "k1s": np.stack([gather(t["k1s"][i]) for i in range(n)], axis=1),
            "k2s": np.stack([gather(t["k2s"][i]) for i in range(n)], axis=1),
            "v_0": gather(t["v_0"])[:, None],
        }
    elif kind in ("polynomial", "quartic_angles"):
        n = t["ks"].shape[0]
        params = {"ks": np.stack([gather(t["ks"][i]) for i in range(n)]),
                  "v_0": gather(t["v_0"])}
    elif kind in ("repulsion", "restricted_quartic"):
        params = {f: gather(t[f]) for f in _PRIOR_TABLES[kind]}
    else:  # harmonic family
        params = {"x0": gather(t["x_0"]), "k": gather(t["k"])}
    return Prior(
        index_mapping=torch.as_tensor(idx, device=device),
        params={k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
                for k, v in params.items()},
        kind=kind,
        name=ref_prior.name,
        feature=_KIND_FEATURES[kind],
    )


def optimized_schnet_config(config: Optional[SchNetConfig],
                            has_exclusions: bool = False
                            ) -> Optional[SchNetConfig]:
    """The default path of an ingested checkpoint: the Chebyshev path at
    bf16 with the full-domain orders (64, 96) where it is eligible, the
    exact ``"xla"`` path where not (reference optimized_schnet_config,
    checkpoint_io.py:609-655). Pair exclusions take xla at bf16, since the
    all-pairs cheb path cannot drop pairs.

    Eligible means a zero-lower CosineCutoff and a tanh activation. The
    reference checks the cutoff only, so a silu or relu checkpoint goes to
    cheb there and the host fit then refuses it: it never runs. Here it
    takes the xla path, where every activation runs."""
    if config is None:
        return config
    if has_exclusions:
        logger.info("[convert] structure carries exc_pair_index; using the "
                    "exact gather message-passing path (message_passing="
                    "'xla', bf16).")
        return dataclasses.replace(config, message_passing="xla",
                                   precision="bf16")
    eligible = (isinstance(config.cutoff, CosineCutoff)
                and config.cutoff.cutoff_lower == 0
                and config.activation == "tanh")
    if not eligible:
        logger.info("[convert] the cutoff is not a zero-lower CosineCutoff "
                    "or the activation is not tanh; using the exact gather "
                    "message-passing path (message_passing='xla').")
        return dataclasses.replace(config, message_passing="xla")
    logger.info("[convert] optimizations ON by default: message_passing="
                "'cheb', precision='bf16', cheb_order=64/96 (optimize=False "
                "keeps the fp32/xla baseline path).")
    return dataclasses.replace(config, message_passing="cheb",
                               precision="bf16", cheb_order=64,
                               cheb_order_deriv=96)


def build_forcefield(
    ref_model: ReferenceModel,
    configuration: Configuration,
    dtype=torch.float32,
    neighbor_capacity: Optional[int] = None,
    optimize: bool = True,
    allow_missing_priors: bool = False,
    tune_configurations: Optional[List[Configuration]] = None,
    device="cuda",
) -> ForceField:
    """Bind a converted checkpoint to a molecule -> runnable ForceField.

    ``optimize=True`` (the default, as the reference's optimizations-on)
    takes :func:`optimized_schnet_config`; on the Chebyshev path it then
    measures the fidelity frontier on ``tune_configurations`` (default:
    ``configuration``) and keeps the cheapest orders and fit domain within
    1.2x the bf16 floor (models/frontier.py; FLASHMD_TPU_AUTOFRONTIER=0
    keeps the full-domain (64, 96)). ``optimize=False`` keeps the exact
    fp32 xla path. A prior without its neighbour list in the structure is
    an error, ``allow_missing_priors=True`` skips it with a warning. A
    term-list repulsion with more than 4 A terms is evaluated densely.
    Without ``neighbor_capacity``, K is the max neighbour count at rcut +
    1.0 (minimum image under the structure's cell) x 1.35, aligned to 8,
    at most A. The tensors are placed on the card unless ``device`` says
    otherwise."""
    schnet_params = _tree_to_torch(ref_model.schnet_params, device, dtype)
    schnet_config = ref_model.schnet_config
    exc = configuration.exc_pair_index
    if optimize and schnet_config is not None:
        schnet_config = optimized_schnet_config(
            schnet_config, has_exclusions=exc is not None)
        if (schnet_config.message_passing == "cheb"
                and schnet_params is not None):
            from .frontier import autofrontier_enabled, select_cheb_frontier

            if autofrontier_enabled():
                schnet_config = select_cheb_frontier(
                    schnet_params, schnet_config,
                    tune_configurations or [configuration],
                )

    priors = {}
    for rp in ref_model.priors:
        if rp.name not in configuration.neighbor_lists:
            if not allow_missing_priors:
                raise ValueError(
                    f"The checkpoint's prior {rp.name!r} has no matching "
                    "neighbor list in the structure file; refusing to "
                    "silently drop physics. Pass allow_missing_priors=True "
                    "to skip it explicitly."
                )
            logger.warning(f"Structure has no neighbor list {rp.name!r}; "
                           "prior skipped.")
            continue
        prior = build_prior(rp, configuration.atom_types,
                            configuration.neighbor_lists[rp.name],
                            device=device, dtype=dtype)
        if prior.kind == "repulsion" and (prior.n_terms
                                          > 4 * configuration.n_atoms):
            prior = densify_repulsion(prior, configuration.n_atoms)
        priors[rp.name] = prior

    if neighbor_capacity is None:
        if schnet_config is not None:
            rcut = float(ref_model.schnet_config.cutoff.cutoff_upper)
            n_max = max_neighbor_count(configuration.pos, rcut + 1.0,
                                       cell=configuration.cell)
            neighbor_capacity = suggest_capacity(n_max, slack=1.35)
        else:
            neighbor_capacity = suggest_capacity(
                min(configuration.n_atoms, 160))
        neighbor_capacity = min(neighbor_capacity, configuration.n_atoms)
    return ForceField(
        schnet_params=schnet_params,
        priors=priors,
        schnet_config=schnet_config,
        neighbor_capacity=neighbor_capacity,
        exc_pair_index=(None if exc is None else
                        torch.as_tensor(exc, dtype=torch.int64,
                                        device=device)),
    )


# ---------------------------------------------------------------------------
# The port's native format: plain dicts of numpy arrays, a format tag
# ---------------------------------------------------------------------------

NATIVE_MODEL_FORMAT = "flashmd_tpu_torch_native_model_v1"
NATIVE_CONFIGURATIONS_FORMAT = "flashmd_tpu_torch_native_configurations_v1"
SPECIALIZED_DUMP_FORMAT = "flashmd_tpu_torch_specialized_model_and_config_v1"
_CUTOFFS = {cls.__name__: cls
            for cls in (CosineCutoff, IdentityCutoff, ShiftedCosineCutoff)}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _config_to_dict(config: Optional[SchNetConfig]) -> Optional[dict]:
    if config is None:
        return None
    out = {}
    for f in dataclasses.fields(config):
        v = getattr(config, f.name)
        if f.name in ("cutoff", "rbf_cutoff"):
            v = {"class": type(v).__name__, **dataclasses.asdict(v)}
        out[f.name] = v
    return out


def _config_from_dict(d: Optional[dict]) -> Optional[SchNetConfig]:
    if d is None:
        return None
    kw = dict(d)
    for name in ("cutoff", "rbf_cutoff"):
        fields = dict(kw[name])
        kw[name] = _CUTOFFS[fields.pop("class")](**fields)
    return config_from_kwargs(kw)


def _prior_to_dict(p: Prior) -> dict:
    return {"index_mapping": _numpy_tree(p.index_mapping),
            "params": _numpy_tree(p.params), "kind": p.kind,
            "name": p.name, "feature": p.feature,
            "term_mask": _numpy_tree(p.term_mask)}


def save_native_model(model, path: str):
    """Write a ReferenceModel or the port's ForceField as the port's
    native file: plain dicts of numpy arrays, the config as a dict, no
    class of either package."""
    with open(path, "wb") as f:
        pickle.dump(_model_payload(model), f)


def _model_payload(model) -> dict:
    if isinstance(model, ReferenceModel):
        payload = {
            "kind": "reference_model",
            "schnet_params": _numpy_tree(model.schnet_params),
            "schnet_config": _config_to_dict(model.schnet_config),
            "priors": [dataclasses.asdict(p) for p in model.priors],
        }
    elif isinstance(model, ForceField):
        payload = {
            "kind": "forcefield",
            "schnet_params": _numpy_tree(model.schnet_params),
            "schnet_config": _config_to_dict(model.schnet_config),
            "priors": {k: _prior_to_dict(p) for k, p in model.priors.items()},
            "neighbor_capacity": int(model.neighbor_capacity),
            "exc_pair_index": _numpy_tree(model.exc_pair_index),
            "pbc_images": model.pbc_images,
            "batched_priors": bool(model.batched_priors),
        }
    else:
        raise TypeError(f"cannot save {type(model)!r}: a ReferenceModel or "
                        "a ForceField of flashmd_tpu_torch")
    return {"format": NATIVE_MODEL_FORMAT, **payload}


# What a native file may name besides builtin containers: numpy's array
# and scalar reconstructors (numpy 2 under ``numpy._core``, numpy 1 under
# ``numpy.core``).
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
}

# The JAX package's classes that its native files hold (save_native_model,
# save_native_configurations, save_specialized_dump there), each read as
# its pickled state and rebuilt as the port's counterpart by _from_jax.
_JAX_CLASSES = {
    "flashmd_tpu.models.forcefield": ("ForceField",),
    "flashmd_tpu.models.schnet": ("SchNetConfig",),
    "flashmd_tpu.models.cutoff": ("CosineCutoff", "IdentityCutoff",
                                  "ShiftedCosineCutoff"),
    "flashmd_tpu.models.radial_basis": ("GaussianBasisConfig",),
    "flashmd_tpu.prior.priors": ("Prior",),
    "flashmd_tpu.data.system": ("Configuration", "TermList"),
    "flashmd_tpu.models.checkpoint_io": ("ReferenceModel", "ReferencePrior"),
}
JAX_SPECIALIZED_DUMP_FORMAT = "flashmd_tpu_specialized_model_and_config_v1"
# classes whose state is already the port's native payload
_NATIVE_DICTS = {"Prior": Prior, "TermList": TermList,
                 "ReferencePrior": ReferencePrior,
                 "Configuration": Configuration}


class _JaxState:
    """A JAX-package object as its file holds it: the class's name and the
    instance's state (its ``__dict__``, as pickle's BUILD gives it)."""

    name = ""

    def __setstate__(self, state):
        self.state = dict(state)


def _array_from_jax(fun, args, arr_state, aval_state):
    """``jax._src.array._reconstruct_array`` without the device_put: the
    numpy array that a pickled JAX array carries."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


class _NativeUnpickler(pickle.Unpickler):
    """Rebuilds builtin containers, numpy arrays and the JAX package's
    native classes (as :class:`_JaxState`), and refuses every other
    global by name: a native file runs no code of its own."""

    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        if name in _JAX_CLASSES.get(module, ()):
            return type(name, (_JaxState,), {"name": name})
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _array_from_jax
        raise pickle.UnpicklingError(
            f"refusing {module}.{name}: a native file of flashmd_tpu or "
            "flashmd_tpu_torch holds numpy arrays, builtin containers and "
            "the packages' own model and structure classes only")


def _fields(name: str, state: dict, cls) -> dict:
    """The state of the JAX package's ``name`` as keyword arguments of the
    port's ``cls``; a field the port does not have raises."""
    names = {f.name for f in dataclasses.fields(cls)}
    extra = set(state) - names
    if extra:
        raise ValueError(f"the JAX package's {name} has fields "
                         f"{sorted(extra)} that flashmd_tpu_torch's "
                         f"{cls.__name__} does not")
    return state


def _from_jax(obj):
    """The JAX package's objects in ``obj`` -> the payloads of the port's
    native format (and its cutoff and basis classes), bottom up."""
    if isinstance(obj, dict):
        return {k: _from_jax(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_jax(v) for v in obj)
    if not isinstance(obj, _JaxState):
        return obj
    name, state = obj.name, _from_jax(obj.state)
    if name in _CUTOFFS:
        return _CUTOFFS[name](**_fields(name, state, _CUTOFFS[name]))
    if name == "GaussianBasisConfig":
        return GaussianBasisConfig(**_fields(name, state,
                                             GaussianBasisConfig))
    if name == "SchNetConfig":
        return _config_to_dict(config_from_kwargs(
            _fields(name, state, SchNetConfig)))
    if name in _NATIVE_DICTS:
        return _fields(name, state, _NATIVE_DICTS[name])
    if name == "ReferenceModel":
        return {"format": NATIVE_MODEL_FORMAT, "kind": "reference_model",
                **_fields(name, state, ReferenceModel)}
    return {"format": NATIVE_MODEL_FORMAT, "kind": "forcefield",
            **_fields(name, state, ForceField)}


def _load_native(path: str, fmt: str, dump_key: str) -> dict:
    """The payload of ``fmt`` in ``path``, a native file of the port or of
    the JAX package; a specialized dump of either unwraps to its
    ``dump_key`` part."""
    with open(path, "rb") as f:
        obj = _NativeUnpickler(f).load()
    if isinstance(obj, dict) and obj.get("format") in (
            SPECIALIZED_DUMP_FORMAT, JAX_SPECIALIZED_DUMP_FORMAT):
        obj = obj[dump_key]
    obj = _from_jax(obj)
    if fmt == NATIVE_CONFIGURATIONS_FORMAT and isinstance(obj, list):
        # the JAX package's structures file: a list of Configurations
        obj = {"format": fmt, "configurations": obj}
    if not (isinstance(obj, dict) and obj.get("format") == fmt):
        raise ValueError(f"{path} is not a {fmt} file")
    return obj


def load_native_model(path: str, device="cuda"):
    """Read :func:`save_native_model`'s file: a ReferenceModel (numpy) or
    a ForceField with its float tensors in float32 on ``device``."""
    obj = _load_native(path, NATIVE_MODEL_FORMAT, "model")
    config = _config_from_dict(obj["schnet_config"])
    if obj["kind"] == "reference_model":
        return ReferenceModel(
            schnet_params=obj["schnet_params"], schnet_config=config,
            priors=[ReferencePrior(**p) for p in obj["priors"]],
        )
    priors = {
        k: Prior(
            index_mapping=_tree_to_torch(p["index_mapping"], device),
            params=_tree_to_torch(p["params"], device),
            kind=p["kind"], name=p["name"], feature=p["feature"],
            term_mask=_tree_to_torch(p["term_mask"], device),
        )
        for k, p in obj["priors"].items()
    }
    params = _tree_to_torch(obj["schnet_params"], device)
    if params is not None and "cheb_fit" in params:
        params["cheb_fit"] = tuple(tuple(f) for f in params["cheb_fit"])
    images = obj["pbc_images"]
    return ForceField(
        schnet_params=params, priors=priors, schnet_config=config,
        neighbor_capacity=obj["neighbor_capacity"],
        exc_pair_index=_tree_to_torch(obj["exc_pair_index"], device),
        pbc_images=None if images is None else tuple(map(tuple, images)),
        batched_priors=bool(obj.get("batched_priors", False)),
    )


def save_native_configurations(configs: List[Configuration], path: str):
    """Write configurations as plain dicts of numpy arrays."""
    with open(path, "wb") as f:
        pickle.dump(_configurations_payload(configs), f)


def _configurations_payload(configs: List[Configuration]) -> dict:
    items = []
    for c in configs:
        d = {f.name: getattr(c, f.name)
             for f in dataclasses.fields(Configuration)}
        d["neighbor_lists"] = {k: dataclasses.asdict(tl)
                               for k, tl in c.neighbor_lists.items()}
        items.append(d)
    return {"format": NATIVE_CONFIGURATIONS_FORMAT, "configurations": items}


def save_specialized_dump(model, configs: List[Configuration], path: str):
    """Write a simulation's ``<filename>_specialized_model_and_config.pkl``
    (reference save_specialized_dump, checkpoint_io.py:793-807): the
    attached ForceField and the configurations in the native formats,
    tagged so that :func:`load_native_model` and
    :func:`load_native_configurations` each unwrap their part."""
    with open(path, "wb") as f:
        pickle.dump({"format": SPECIALIZED_DUMP_FORMAT,
                     "model": _model_payload(model),
                     "configurations": _configurations_payload(configs)}, f)


def load_native_configurations(path: str) -> List[Configuration]:
    """Read :func:`save_native_configurations`' file."""
    obj = _load_native(path, NATIVE_CONFIGURATIONS_FORMAT, "configurations")
    out = []
    for d in obj["configurations"]:
        d = dict(d)
        d["neighbor_lists"] = {k: TermList(**tl)
                               for k, tl in d["neighbor_lists"].items()}
        out.append(Configuration(**d))
    return out
