"""The ('data', 'model') mesh over processes and the sharding rules
(``transformertts_tpu/parallel/mesh.py``).

The JAX package has one program over a device mesh and lets GSPMD derive
the collectives from parameter shardings.  Here each device is one process
(``torch.distributed``: NCCL on CUDA, gloo on the CPU) and the collectives
are written out (``collectives.py``):

- DP over ``data``: each rank holds ``B / n_data`` rows of the batch;
  gradients are summed over ``data``; BatchNorm sums its batch moments
  over ``data``; every dropout mask is drawn at the global shape and
  sliced, so a sharded step drops what the one-process step drops.
- TP over ``model`` (Megatron): ``q_proj`` / ``k_proj`` / ``v_proj`` and
  ``ffn.Dense_0`` split their output features (whole heads, d_ffn
  columns), ``out_proj`` and ``ffn.Dense_1`` their input features; each
  attention block and each FFN block has one all-reduce on its output.
- SP (``shard_sequence``): the mel and phoneme time axes also ride
  ``model`` between blocks; each block all-gathers its input on time and
  reduce-scatters its output in place of TP's all-reduce; the kernel-5
  convolution stacks of the encoder prenet and the postnet gather time
  before and slice after, so BatchNorm's moments stay whole.

The rules of ``transformertts_tpu/parallel/mesh.py:_TP_RULES`` are written
for flax's (in, out) kernels; torch's ``Linear.weight`` is (out, in), so a
JAX ``P(None, 'model')`` kernel is a ``('model', None)`` weight here.
``param_spec`` returns that form: one mesh axis name or None per dimension,
``()`` for a replicated tensor.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist

from transformertts_tpu_torch.parallel import collectives as C

# (name regex, spec of the torch tensor) — first match wins; default replicated
_TP_RULES: list[tuple[str, tuple]] = [
    (r"(q_proj|k_proj|v_proj)\.weight$", ("model", None)),
    (r"(q_proj|k_proj|v_proj)\.bias$", ("model",)),
    (r"out_proj\.weight$", (None, "model")),
    (r"ffn\.Dense_0\.weight$", ("model", None)),
    (r"ffn\.Dense_0\.bias$", ("model",)),
    (r"ffn\.Dense_1\.weight$", (None, "model")),
    (r"emb\.weight$", (None, None)),
]

# batch keys whose (batch-relative) axis 1 is a time axis that sequence
# parallelism shards over 'model'
_SEQ_KEYS = ("melspec", "phoneme")


class Mesh:
    """This process's place in the (n_data, n_model) mesh: rank ``data *
    n_model + model`` (the JAX mesh's row-major device order), and the
    process groups of its mesh row (``model_group``: the ranks of one data
    shard) and column (``data_group``); a group is None on an axis of size 1.
    ``ranks`` are the mesh's processes in the default group, ``group`` the
    group of all of them (None: the default group)."""

    def __init__(self, n_data: int = 1, n_model: int = 1, data_rank: int = 0,
                 model_rank: int = 0, data_group=None, model_group=None, ranks=(0,),
                 group=None):
        self.n_data, self.n_model = n_data, n_model
        self.data_rank, self.model_rank = data_rank, model_rank
        self.data_group, self.model_group = data_group, model_group
        self.ranks, self.group = list(ranks), group

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def rank(self) -> int:
        return self.data_rank * self.n_model + self.model_rank

    def __repr__(self) -> str:
        return (f"Mesh(data={self.n_data}, model={self.n_model}, "
                f"coords=({self.data_rank}, {self.model_rank}))")

    def __deepcopy__(self, memo):  # process groups are not copied
        return self


def make_mesh(n_data: int = -1, n_model: int = 1, ranks=None) -> Mesh | None:
    """The mesh over the processes ``ranks`` of the default process group
    (all of them by default, as the JAX ``devices``; one process, no group,
    when ``torch.distributed`` is not initialised).  ``n_data == -1`` takes
    every process that ``n_model`` leaves.  Raises unless ``n_data *
    n_model`` is the number of processes: a process cannot sit idle.  Every
    process of the world must call this, in the same order (it creates the
    groups); one outside ``ranks`` gets None."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if ranks is None else list(ranks)
    if n_model < 1 or len(ranks) % n_model:
        raise ValueError(f"mesh_model={n_model} does not divide the {len(ranks)} processes")
    if n_data == -1:
        n_data = len(ranks) // n_model
    if n_data * n_model != len(ranks):
        raise ValueError(f"a mesh of {n_data} data x {n_model} model needs {n_data * n_model} "
                         f"processes, it has {len(ranks)}")
    if world == 1:
        return Mesh()
    me = ranks.index(dist.get_rank()) if dist.get_rank() in ranks else None
    coords = divmod(me, n_model) if me is not None else (None, None)
    groups = {"all": dist.new_group(ranks) if len(ranks) < world else None}
    if n_model > 1:  # a row of the mesh: the model ranks of one data shard
        for d in range(n_data):
            groups["model", d] = dist.new_group([ranks[d * n_model + m] for m in range(n_model)])
    if n_data > 1:  # a column: the data ranks of one model shard
        for m in range(n_model):
            groups["data", m] = dist.new_group([ranks[d * n_model + m] for d in range(n_data)])
    if me is None:
        return None
    data_rank, model_rank = coords
    return Mesh(n_data, n_model, data_rank, model_rank, groups.get(("data", model_rank)),
                groups.get(("model", data_rank)), ranks, groups["all"])


class Layout:
    """What the modules of one process's model need of the mesh: how their
    tensors are split and the collectives around a block.  ``Layout()``
    (one process) makes every method the identity."""

    def __init__(self, mesh: Mesh | None = None, seq: bool = False):
        self.mesh = mesh or Mesh()
        self.seq = bool(seq) and self.mesh.n_model > 1

    def __deepcopy__(self, memo):
        return self

    @property
    def sharded(self) -> bool:
        return self.mesh.size > 1

    @property
    def tp(self) -> bool:
        return self.mesh.n_model > 1

    def span(self, axis, n: int) -> tuple[int, int]:
        """(global size, this rank's offset) of a dimension of local size n
        split over ``axis``: 'data', 'model', 'time' (the model axis under
        sequence parallelism) or None."""
        m = self.mesh
        if axis == "data":
            return n * m.n_data, n * m.data_rank
        if axis == "model" or (axis == "time" and self.seq):
            return n * m.n_model, n * m.model_rank
        return n, 0

    def global_view(self, shape, axes) -> tuple[tuple, tuple]:
        """The one-process shape of a local tensor whose leading dimensions
        are split over ``axes``, and the index of the local part in it."""
        spans = [self.span(axes[i] if i < len(axes) else None, n) for i, n in enumerate(shape)]
        return (tuple(t for t, _ in spans),
                tuple(slice(o, o + n) for (_, o), n in zip(spans, shape)))

    def time_total(self, t_local: int) -> int:
        return self.span("time", t_local)[0]

    def time_offset(self, t_local: int) -> int:
        return self.span("time", t_local)[1]

    # --- the collectives around a tensor-parallel block ---

    def enter(self, x):
        """A block's input: gathered on time (SP) or f (TP)."""
        g = self.mesh.model_group
        return C.gather_seq(x, g) if self.seq else C.copy_to(x, g)

    def exit(self, y):
        """A block's partial output: reduce-scattered on time (SP) or g (TP)."""
        g = self.mesh.model_group
        return C.scatter_seq(y, g) if self.seq else C.reduce_from(y, g)

    def gather_time(self, x):
        """The whole time axis of an activation, for a stack that needs it."""
        return C.gather_seq(x, self.mesh.model_group) if self.seq else x

    def local_time(self, x):
        """This rank's time slice of a whole-time activation."""
        if not self.seq:
            return x
        t = x.shape[1] // self.mesh.n_model
        return x[:, self.mesh.model_rank * t:(self.mesh.model_rank + 1) * t]

    def sum_data(self, x):
        """A sum over the data ranks that every rank's loss depends on
        (all-reduce forward and backward)."""
        return C.sum_both(x, self.mesh.data_group)

    def total(self, x, over_time: bool = True):
        """The sum over the ranks that hold other parts of a loss's data (no
        gradient): the data ranks, and the model ranks when ``over_time``
        and the time axis is split."""
        with torch.no_grad():
            x = C.all_reduce(x, self.mesh.data_group) if self.mesh.n_data > 1 else x
            if over_time and self.seq:
                x = C.all_reduce(x, self.mesh.model_group)
        return x


SINGLE = Layout()


def param_spec(name: str, tp: bool) -> tuple:
    """The spec of the torch tensor ``name`` (a ``state_dict`` key, or an
    Adam moment's or EMA copy's, which share the parameter names)."""
    if tp:
        for pattern, spec in _TP_RULES:
            if re.search(pattern, name):
                return spec
    return ()


def split_dim(spec: tuple):
    """The dimension a spec splits over the model ranks, or None (replicated)."""
    return spec.index("model") if "model" in spec else None


def shard_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's part of the full tensor ``t`` (a copy)."""
    dim = split_dim(spec)
    if dim is None or mesh.n_model == 1:
        return t.clone()
    n = t.shape[dim]
    if n % mesh.n_model:
        raise ValueError(f"a dimension of {n} does not split over {mesh.n_model} model ranks")
    return t.narrow(dim, mesh.model_rank * (n // mesh.n_model), n // mesh.n_model).clone()


def gather_tensor(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every model rank's part (a collective over the
    rank's model group; every rank of it must call)."""
    dim = split_dim(spec)
    if dim is None or mesh.n_model == 1:
        return t
    return C.all_gather(t, mesh.model_group, dim)


def state_shardings(state, mesh: Mesh) -> dict:
    """TrainState -> {"params" | "mu" | "nu" | "ema": {name: spec}}."""
    tp = mesh.n_model > 1
    names = [k for k, _ in state.model.named_parameters()]
    out = {"params": {k: param_spec(k, tp) for k in names}}
    for key in ("mu", "nu"):
        out[key] = {k: param_spec(k, tp) for k in state.opt_state[key]}
    if state.ema_params is not None:
        out["ema"] = {k: param_spec(k, tp) for k in state.ema_params}
    return out


def check_divisible(cfg, mesh: Mesh) -> None:
    """Raise, with the numbers, unless every attention's heads and every
    FFN's d_ffn split over the model ranks."""
    n = mesh.n_model
    for what, value in (("encoder_n_head", cfg.encoder_n_head),
                        ("decoder_n_head", cfg.decoder_n_head),
                        ("encoder_d_ffn", cfg.encoder_d_ffn),
                        ("decoder_d_ffn", cfg.decoder_d_ffn)):
        if value % n:
            raise ValueError(f"model.{what}={value} does not split over {n} model ranks")


def shard_state(state, mesh: Mesh, shard_sequence: bool = False):
    """Slice a TrainState holding full tensors to this rank's parts, in
    place: parameters (the model's), Adam moments and the EMA copy, by
    ``param_spec``; then set the model's ``Layout`` (``shard_sequence``: SP).
    Returns the state."""
    model = state.model
    check_divisible(model.cfg, mesh)
    tp = mesh.n_model > 1
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = shard_tensor(p.data, param_spec(name, tp), mesh)
        for key in ("mu", "nu"):
            state.opt_state[key] = {k: shard_tensor(v, param_spec(k, tp), mesh)
                                    for k, v in state.opt_state[key].items()}
        if state.ema_params is not None:
            state.ema_params = {k: shard_tensor(v, param_spec(k, tp), mesh)
                                for k, v in state.ema_params.items()}
    model.set_layout(Layout(mesh, shard_sequence))
    return state


def gather_tree(tree: dict, mesh: Mesh) -> dict:
    """{name: full tensor} of a dict of this rank's parts keyed by parameter
    (or state) names; a tensor that is not split is the dict's own.  A
    collective over the rank's model group: every rank of it must call."""
    tp = mesh.n_model > 1
    return {k: gather_tensor(v.detach(), param_spec(k, tp), mesh) for k, v in tree.items()}


def gather_state(state) -> dict:
    """The full tensors of a (possibly sharded) TrainState: {"model":
    state_dict, "mu", "nu", "ema": {name: tensor} (ema None without one)}
    (``gather_tree`` of each)."""
    mesh = state.model.layout.mesh
    return {"model": gather_tree(state.model.state_dict(), mesh),
            "mu": gather_tree(state.opt_state["mu"], mesh),
            "nu": gather_tree(state.opt_state["nu"], mesh),
            "ema": gather_tree(state.ema_params, mesh) if state.ema_params is not None else None}


def batch_shardings(batch: dict, mesh: Mesh, has_accum_dim: bool = True,
                    shard_sequence: bool = False) -> dict:
    """{key: spec} of a batch: the batch axis over 'data' and, with
    ``shard_sequence``, the time axis of mel and phoneme over 'model'."""
    axis = 1 if has_accum_dim else 0

    def spec(k, x):
        parts = [None] * x.ndim
        parts[axis] = "data"
        if shard_sequence and k in _SEQ_KEYS and x.ndim > axis + 1:
            parts[axis + 1] = "model"
        return tuple(parts)

    return {k: spec(k, v) for k, v in batch.items()}


def shard_batch(batch: dict, mesh: Mesh, has_accum_dim: bool = True,
                shard_sequence: bool = False, rows: bool = True) -> dict:
    """This rank's rows ((K, B, ...) or (B, ...)) and, with
    ``shard_sequence``, its time slice of mel and phoneme, as tensors
    (``rows=False``: the batch holds this rank's rows already, as a
    process shard of ``BucketedLoader`` does).  Raises, with the numbers,
    when B or T does not split evenly."""
    out = {}
    for k, spec in batch_shardings(batch, mesh, has_accum_dim, shard_sequence).items():
        x = torch.as_tensor(batch[k])
        for dim, axis in enumerate(spec):
            if axis is None or (axis == "data" and not rows):
                continue
            n, rank = (mesh.n_data, mesh.data_rank) if axis == "data" else (
                mesh.n_model, mesh.model_rank)
            if x.shape[dim] % n:
                what = "batch" if axis == "data" else "time"
                raise ValueError(f"{k}: {what} axis of {x.shape[dim]} does not split over "
                                 f"{n} {axis} ranks")
            size = x.shape[dim] // n
            x = x.narrow(dim, rank * size, size)
        out[k] = x.contiguous()
    return out
