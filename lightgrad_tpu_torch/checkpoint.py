"""Checkpoint save / resume: model parameters and optimizer state in one
compressed npz file.

Counterpart of the single-file half of ``lightgrad_tpu/checkpoint.py``
(``save_checkpoint``, ``load_checkpoint``, ``optimizer_state_dict``,
``load_optimizer_state``), with its layout, so each package reads the
other's files: the parameters under their ``state_dict`` names (per-layer
names for a scanned stack), then the optimizer's state under
``__optim__/`` (Adam and its subclasses: ``t``, ``m.{i}``, ``v.{i}``; SGD
with momentum: ``velocity.{i}``; ``i`` is the parameter's position), then
``__meta__/`` entries (``step`` and any keyword).  bfloat16 is widened to
float32, which is exact, and each tensor takes the file's values back in
its own dtype.  The file is written to ``path + ".tmp"`` and renamed over
``path``, so a crash never leaves half a checkpoint.

Both model worlds: a ``torch.nn.Module`` (GPT-2; ``state_dict`` /
``load_state_dict``) or a lightgrad tape module (``state_dict`` /
``load_parameters``).  The optimizer state is the port's torch tensors,
loaded in place on their device.  A resumed run repeats the uninterrupted
one bit for bit (tests/test_torch_checkpoint.py, ``chip_smoke.py``).

The sharded pair (``save_checkpoint_sharded`` / ``load_checkpoint_sharded``)
writes each process's owned shards of every parameter, buffer and
optimizer-state tensor (sharded ones are the parallel layer's
``DTensor``s) to ``shards-{process:05d}.npz`` beside a ``meta.json``, in
the JAX package's layout (keys ``name//start:stop,...``), so each package
reads the other's directories; a tensor whose live placement differs from
the saved one is resharded on load.
"""

import glob
import io
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .optim import SGD, Adam, Optimizer

__all__ = ["save_checkpoint", "load_checkpoint", "optimizer_state_dict",
           "load_optimizer_state", "save_checkpoint_sharded",
           "load_checkpoint_sharded"]

_OPT_PREFIX = "__optim__/"
_META_PREFIX = "__meta__/"


# a member's raw deflate stream is compressed in pieces of this many bytes,
# all in parallel (zlib lets go of the GIL), and the pieces joined after a
# sync flush each (pigz's scheme)
_PIECE = 8 << 20
_ZIP64_LIMIT = (1 << 31) - 1    # zipfile's own threshold for zip64 fields
_DOS_DATE = 33                  # 1980-01-01, the date numpy's savez writes


def _deflate(buf, lo, last, level, strategy):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return c.compress(buf[lo:lo + _PIECE]) + c.flush(
        zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


def _zip64(*values):
    """The zip64 extra field holding ``values``, and the 32-bit stand-in
    (0xFFFFFFFF) or value of each."""
    big = [v for v in values if v >= _ZIP64_LIMIT]
    extra = struct.pack("<HH" + "Q" * len(big), 1, 8 * len(big), *big) \
        if big else b""
    return extra, [0xFFFFFFFF if v >= _ZIP64_LIMIT else v for v in values]


def _write_npz(f, arrays: dict, level: int = 6) -> None:
    """Write ``arrays`` to the file ``f`` as a compressed npz (a zip of
    deflated ``.npy`` members, zip64 fields only where a size or offset
    needs them, as ``zipfile`` writes them), deflating the members' pieces
    on all cores; ``np.load`` reads the same arrays as from
    ``np.savez_compressed``.  Floating members are Huffman-coded without
    LZ77 matching (``Z_HUFFMAN_ONLY``): weights and moments hold no repeats
    to match, and on N(0, 0.02) float32 this sandbox measured the same size
    (0.925 of the raw bytes) at 3x the speed of level 6's matching."""
    names, bufs, strategies = [], [], []
    for k, v in arrays.items():
        v = np.asanyarray(v)
        b = io.BytesIO()
        np.lib.format.write_array(b, v, allow_pickle=False)
        names.append((k + ".npy").encode("utf-8"))
        bufs.append(b.getbuffer())
        strategies.append(zlib.Z_HUFFMAN_ONLY if v.dtype.kind == "f"
                          else zlib.Z_DEFAULT_STRATEGY)
    tasks = [(i, lo, lo + _PIECE >= len(b)) for i, b in enumerate(bufs)
             for lo in range(0, len(b), _PIECE)]
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        pieces = list(pool.map(
            lambda t: _deflate(bufs[t[0]], t[1], t[2], level,
                               strategies[t[0]]), tasks))
    streams = [[] for _ in bufs]
    for (i, _, _), piece in zip(tasks, pieces):
        streams[i].append(piece)
    central, off = [], 0
    for name, buf, stream in zip(names, bufs, streams):
        crc = zlib.crc32(buf)
        usize, csize = len(buf), sum(len(p) for p in stream)
        extra, (u32, c32) = _zip64(usize, csize)
        ver = 45 if extra else 20
        head = struct.pack("<IHHHHHIIIHH", 0x04034B50, ver, 0x800, 8, 0,
                           _DOS_DATE, crc, c32, u32, len(name), len(extra))
        f.write(head + name + extra)
        for p in stream:
            f.write(p)
        cextra, (u32, c32, o32) = _zip64(usize, csize, off)
        ver = 45 if cextra else 20
        central.append(struct.pack(
            "<IHHHHHHIIIHHHHHII", 0x02014B50, ver, ver, 0x800, 8, 0,
            _DOS_DATE, crc, c32, u32, len(name), len(cextra), 0, 0, 0, 0,
            o32) + name + cextra)
        off += len(head) + len(name) + len(extra) + csize
    cd = b"".join(central)
    f.write(cd)
    n = len(central)
    if n > 0xFFFF or len(cd) >= _ZIP64_LIMIT or off >= _ZIP64_LIMIT:
        f.write(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0, n,
                            n, len(cd), off))
        f.write(struct.pack("<IIQI", 0x07064B50, 0, off + len(cd), 1))
        f.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, 0xFFFF, 0xFFFF,
                            0xFFFFFFFF, 0xFFFFFFFF, 0))
    else:
        f.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, n, n, len(cd),
                            off, 0))


def _read_npz(path: str) -> dict:
    """{name: array} of an npz, its members inflated in parallel: each
    thread opens the file itself (threads sharing one ZipFile race on its
    file position)."""
    with np.load(path) as z:
        names = z.files
    n = max(1, min(os.cpu_count() or 1, len(names)))

    def part(keys):
        with np.load(path) as z:
            return {k: z[k] for k in keys}

    out = {}
    with ThreadPoolExecutor(n) as pool:
        for d in pool.map(part, [names[i::n] for i in range(n)]):
            out.update(d)
    return {k: out[k] for k in names}


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16 widened to float32 (exact)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def optimizer_state_dict(optim: Optimizer) -> dict:
    """Flatten optimizer state to name -> ndarray."""
    state = {}
    if isinstance(optim, Adam):
        state["t"] = _host(optim.t)
        for i, (m, v) in enumerate(zip(optim.m, optim.v)):
            state[f"m.{i}"] = _host(m)
            state[f"v.{i}"] = _host(v)
    elif isinstance(optim, SGD) and optim.velocity is not None:
        for i, vel in enumerate(optim.velocity):
            state[f"velocity.{i}"] = _host(vel)
    return state


@torch.no_grad()
def load_optimizer_state(optim: Optimizer, state: dict) -> None:
    """Copy ``state`` into the optimizer's tensors in place (their device
    and dtype kept)."""
    def assign(t, arr):
        t.copy_(torch.from_numpy(np.asarray(arr)).reshape(t.shape))

    if isinstance(optim, Adam):
        if "t" in state:
            assign(optim.t, state["t"])
        for i in range(len(optim.parameters)):
            if f"m.{i}" in state:
                assign(optim.m[i], state[f"m.{i}"])
                assign(optim.v[i], state[f"v.{i}"])
    elif isinstance(optim, SGD) and optim.velocity is not None:
        for i in range(len(optim.parameters)):
            if f"velocity.{i}" in state:
                assign(optim.velocity[i], state[f"velocity.{i}"])


def _model_state(model) -> dict:
    if isinstance(model, torch.nn.Module):
        return {k: _host(v) for k, v in model.state_dict().items()}
    return dict(model.state_dict())


def save_checkpoint(path: str, model, optim: Optimizer = None,
                    step: int = None, **extra) -> None:
    """Atomically write model (+ optimizer) state to ``path`` (npz)."""
    arrays = _model_state(model)
    if optim is not None:
        for k, v in optimizer_state_dict(optim).items():
            arrays[_OPT_PREFIX + k] = v
    if step is not None:
        arrays[_META_PREFIX + "step"] = np.asarray(step)
    for k, v in extra.items():
        arrays[_META_PREFIX + k] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _write_npz(f, arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, model, optim: Optimizer = None) -> dict:
    """Restore model (+ optimizer) state; returns the meta dict."""
    arrays = _read_npz(path)
    params = {k: v for k, v in arrays.items()
              if not k.startswith((_OPT_PREFIX, _META_PREFIX))}
    if isinstance(model, torch.nn.Module):
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in params.items()})
    else:
        model.load_parameters(params)
    model.__dict__.pop("_kv_fns", None)   # decode functions hold old weights
    if optim is not None:
        load_optimizer_state(optim, {
            k[len(_OPT_PREFIX):]: v for k, v in arrays.items()
            if k.startswith(_OPT_PREFIX)})
    return {k[len(_META_PREFIX):]: v for k, v in arrays.items()
            if k.startswith(_META_PREFIX)}


# --------------------------- sharded checkpoints ---------------------------
def _optimizer_state_tensors(optim: Optimizer) -> dict:
    """name -> tensor over an optimizer's state: every public attribute
    that is a tensor or a list of tensors (Adam's ``t``, ``m.{i}``,
    ``v.{i}``; SGD's ``velocity.{i}``; ...), the JAX package's walk."""
    out = {}
    for attr, val in sorted(vars(optim).items()):
        if attr == "parameters" or attr.startswith("_"):
            continue
        if isinstance(val, torch.Tensor):
            out[attr] = val
        elif isinstance(val, (list, tuple)) and val and \
                all(isinstance(x, (torch.Tensor, type(None))) for x in val):
            for i, x in enumerate(val):
                if x is not None:
                    out[f"{attr}.{i}"] = x
    return out


def _named_state_tensors(model, optim: Optimizer = None) -> dict:
    """name -> tensor: a tape tensor (its buffer is ``.data``) or a torch
    tensor, plain or ``DTensor``."""
    out = dict(model.named_parameters())
    out.update({"__buf__/" + n: b for n, b in model.named_buffers()})
    if optim is not None:
        out.update({_OPT_PREFIX + k: t
                    for k, t in _optimizer_state_tensors(optim).items()})
    return out


def _raw(t):
    return t if isinstance(t, torch.Tensor) else t.data


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _owned_slices(a):
    """The global slices of this process's shard of DTensor ``a``, and
    whether it owns them (replica 0: coordinate 0 on every mesh dim that
    does not shard it)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = a.device_mesh
    shape, offset = compute_local_shape_and_global_offset(
        a.shape, mesh, a.placements)
    coord = mesh.get_coordinate()
    owner = coord is not None and all(
        c == 0 for c, p in zip(coord, a.placements) if not p.is_shard())
    return tuple(slice(o, o + n) for o, n in zip(offset, shape)), owner


def _key(slices) -> str:
    return ",".join(f"{s.start}:{s.stop}" for s in slices)


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def save_checkpoint_sharded(dir_path: str, model, optim: Optimizer = None,
                            step: int = None, **extra) -> None:
    """Write each process's OWNED shards (replica 0) of every model /
    optimizer tensor to ``dir_path/shards-{process:05d}.npz`` and a
    ``meta.json``.  Unlike ``save_checkpoint`` no process gathers a whole
    sharded tensor: per-process traffic and memory are 1/N for FSDP / TP
    state.  All processes call this (each writes its own file; process 0
    writes the metadata and the whole, unsharded tensors), and it returns
    when every file is written."""
    os.makedirs(dir_path, exist_ok=True)
    proc = _process_index()
    entries, arrays = {}, {}
    for name, t in _named_state_tensors(model, optim).items():
        a = _raw(t).detach()
        entries[name] = {"shape": list(a.shape), "dtype": _dtype_name(a.dtype)}
        if hasattr(a, "placements"):
            slices, owner = _owned_slices(a)
            if owner:
                arrays[f"{name}//{_key(slices)}"] = _host(a.to_local())
        elif proc == 0:
            arrays[f"{name}//{_key(slice(0, n) for n in a.shape)}"] = _host(a)
    tmp = os.path.join(dir_path, f".shards-{proc:05d}.tmp")
    with open(tmp, "wb") as f:
        _write_npz(f, arrays)
    os.replace(tmp, os.path.join(dir_path, f"shards-{proc:05d}.npz"))
    if proc == 0:
        meta = {"format": 1, "entries": entries,
                "meta": {k: (int(v) if isinstance(v, (int, np.integer))
                             else v)
                         for k, v in dict(step=step, **extra).items()
                         if v is not None}}
        tmp = os.path.join(dir_path, ".meta.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(dir_path, "meta.json"))
    _barrier()


def _parse_key(key: str):
    name, _, idx = key.rpartition("//")
    slices = tuple(slice(int(a), int(b)) for a, b in
                   (part.split(":") for part in idx.split(",") if part))
    return name, slices


def _assemble(shards: dict, shape, want):
    """The region ``want`` (slices) of a tensor of ``shape`` from its saved
    shards {slices: array}: one shard itself where it matches, else cut
    from the whole array assembled on the host."""
    if want in shards:
        return shards[want]
    first = next(iter(shards.values()))
    full = np.empty(shape, dtype=first.dtype)
    for slices, arr in shards.items():
        full[slices if slices else ...] = arr
    return full[want] if want else full


@torch.no_grad()
def load_checkpoint_sharded(dir_path: str, model, optim: Optimizer = None
                            ) -> dict:
    """Restore state saved by ``save_checkpoint_sharded`` (by this package
    or the JAX package).  Each tensor keeps its live placement: a sharded
    one takes its own region, straight from the saved shard where the
    saved layout matches and cut from the host-assembled whole where it
    does not (resharding, e.g. fsdp=4 to tp=2).  Returns the meta dict."""
    with open(os.path.join(dir_path, "meta.json")) as f:
        meta = json.load(f)
    saved = {}
    for path in sorted(glob.glob(os.path.join(dir_path, "shards-*.npz"))):
        for key, arr in _read_npz(path).items():
            name, slices = _parse_key(key)
            saved.setdefault(name, {})[slices] = arr
    tensors = _named_state_tensors(model, optim)
    for name, info in meta["entries"].items():
        if name not in tensors:
            continue    # e.g. optimizer state saved but no optimizer passed
        t = tensors[name]
        shards = saved.get(name, {})
        assert shards, f"checkpoint has no shards for {name}"
        shape = tuple(info["shape"])
        a = _raw(t)
        if hasattr(a, "placements"):
            want, _ = _owned_slices(a)
            arr = _assemble(shards, shape, want)
            local = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=a.device, dtype=a.dtype)
            if isinstance(t, torch.Tensor):
                a.to_local().copy_(local)
            else:
                from torch.distributed.tensor import DTensor

                t._set_data(DTensor.from_local(local, a.device_mesh,
                                               a.placements, run_check=False))
            continue
        arr = _assemble(shards, shape, tuple(slice(0, n) for n in shape))
        new = torch.from_numpy(np.ascontiguousarray(arr)).reshape(shape).to(
            device=a.device, dtype=a.dtype)
        if isinstance(t, torch.Tensor):
            a.copy_(new)
        else:
            t._set_data(new)
    model.__dict__.pop("_kv_fns", None)   # decode functions hold old weights
    return meta.get("meta", {})
