"""Compiled steps: a step body captured once per input signature as a CUDA
graph and replayed on every later call.

``fhpe_tpu`` runs each step as one program compiled by ``jax.jit``, which
compiles again for a new signature.  :class:`CapturedStep` is the port's
counterpart for the train, FPD, eval and serve steps.  On the card the
first call with a new signature runs the body once eagerly (a real step,
on a side stream, as PyTorch's whole-network capture recipe asks), then
captures it over static input buffers without running it; every later
call copies the batch into those buffers and replays.  On the CPU the body
runs as it is: graphs are CUDA-only, and that is the tests' path.  A
capture that fails raises; nothing runs the body eagerly on the card in
its place.

:func:`constant` holds the small tensors a step builds from host values
(ImageNet mean and std, the flip permutation), made once per device, so
that no step body copies host data to the card.  :func:`before_capture`
runs a callable before every call that captures (the CLIs' stall
watchdog disarms there, ``utils/watchdog.py``).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .spans import span

# The kernels' launch counters: {kernel: (module of fhpe_tpu_torch.ops,
# attribute)}.  Each wrapper counts its host calls; a capture's calls are
# not launches, and each replay launches what its capture recorded.
LAUNCH_COUNTERS = {
    "decode_heatmaps": ("decode", "decode_kernel_launches"),
    "pairwise_oks": ("nms_torch", "pairwise_oks_launches"),
    "greedy_nms_mask": ("nms_torch", "greedy_nms_launches"),
    "oks_nms_segments": ("nms_torch", "oks_nms_segment_launches"),
    "conv3x3_wgrad": ("conv_wgrad", "conv_wgrad_launches"),
    "branch_chain_eval": ("branch_chain", "branch_chain_eval_launches"),
    "branch_chain_train": ("branch_chain", "branch_chain_train_launches"),
    "conv3x3_fwd": ("conv3x3_fwd", "conv3x3_fwd_launches"),
    "conv3x3_fwd_f32": ("conv3x3_fwd", "conv3x3_fwd_f32_launches"),
}

_constants: Dict[tuple, torch.Tensor] = {}
# zero-argument callables run before a call that captures a graph
_before_capture: list = []


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype)`` on ``device``, made on the first
    call for these values and returned again after; callers only read
    it."""
    arr = np.asarray(values)
    device = torch.device(device)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, dtype, device)
    t = _constants.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.as_tensor(arr).to(device=device, dtype=dtype)
        _constants[key] = t
    return t


@contextlib.contextmanager
def before_capture(fn: Callable[[], None]):
    """Inside this context, ``fn()`` runs before every :class:`CapturedStep`
    call that captures a graph: the call that runs the step eagerly, may
    build the kernels (``ops/_build.py``, at their first use) and records
    the graph, which takes longer than a replay."""
    _before_capture.append(fn)
    try:
        yield
    finally:
        _before_capture.remove(fn)


def launch_counters() -> dict:
    """{kernel: (module, attribute)} of every kernel's launch counter."""
    return {name: (importlib.import_module(f"fhpe_tpu_torch.ops.{mod}"),
                   attr) for name, (mod, attr) in LAUNCH_COUNTERS.items()}


@functools.cache
def _counters() -> tuple:
    """The (module, attribute) pairs of :func:`launch_counters`, imported
    once, on the first capture."""
    return tuple(launch_counters().values())


def _counter_values() -> list:
    return [getattr(m, attr) for m, attr in _counters()]


def _add_launches(counts) -> None:
    for (m, attr), n in zip(_counters(), counts):
        if n:
            setattr(m, attr, getattr(m, attr) + n)


def cuda_capture(run: Callable[[], dict]) -> Tuple[Callable[[], None], dict]:
    """Capture ``run()`` into a CUDA graph without running it; returns
    (replay, the outputs ``run`` returned, which each replay rewrites).
    ``thread_local``: the loader's threads may call the CUDA runtime (the
    nvJPEG route) while this thread captures."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = run()
    return graph.replay, out


@dataclass
class _Graph:
    static: Dict[str, torch.Tensor]     # the inputs the graph reads
    out: Dict[str, torch.Tensor]        # the outputs each replay rewrites
    replay: Callable[[], None]
    fingerprint: tuple
    launches: list                      # kernel launches per replay


_submodules = weakref.WeakKeyDictionary()


def storage_fingerprint(modules, optimizer=None) -> tuple:
    """What a graph captured over ``modules`` (and ``optimizer``) reads
    from the host's side: the data pointers of their parameters, buffers
    and optimizer state, each module's ``training`` flag, and the learning
    rates that are host floats (SGD bakes its rate into its kernels, so a
    new rate needs a new capture; capturable Adam reads a device tensor).
    A module's tree is walked once and kept: a submodule added later is
    not seen."""
    out = []
    for m in modules:
        subs = _submodules.get(m)
        if subs is None:
            subs = _submodules[m] = list(m.modules())
        out.append(m.training)
        out += [t.data_ptr() for sub in subs
                for d in (sub._parameters, sub._buffers)
                for t in d.values() if t is not None]
    if optimizer is not None:
        out += [v.data_ptr() for st in optimizer.state.values()
                for v in st.values() if isinstance(v, torch.Tensor)]
        for g in optimizer.param_groups:
            lr = g["lr"]
            out.append(lr.data_ptr() if isinstance(lr, torch.Tensor)
                       else float(lr))
    return tuple(out)


def _batch_device(batch) -> torch.device:
    devices = {v.device for v in batch.values()}
    if len(devices) != 1:
        raise ValueError(f"a step's batch lies on one device, got {devices}")
    return devices.pop()


def _signature(owner, batch, device) -> tuple:
    kind = device.type
    return (id(owner), torch.is_grad_enabled(),
            torch.is_autocast_enabled(kind), torch.get_autocast_dtype(kind),
            tuple((k, tuple(v.shape), v.dtype)
                  for k, v in sorted(batch.items())))


def _fresh(out: dict) -> dict:
    return {k: v.clone() for k, v in out.items()}


class CapturedStep:
    """``step(owner, batch) -> outputs``, a captured graph per signature.

    body : ``(owner, batch) -> {name: tensor}``, the eager step; it may
        update ``owner``'s tensors in place (parameters, BatchNorm
        statistics, optimizer state) but must not copy host data to the
        card, read the card, or branch on a device value.
    fingerprint : ``owner -> tuple``, what a graph depends on besides the
        batch (:func:`storage_fingerprint`).  A graph whose fingerprint
        changed (storage replaced by ``optimizer.load_state_dict``,
        ``model.to``, ``load_state_dict(assign=True)``, a new SGD rate, a
        module switched between train and eval) is captured again; a
        stale graph is never replayed.  Other host attributes the body
        reads (a chain's ``fused``, a conv's ``fwd_kernel``) are baked in
        at the capture: to change them, make a new step.
    capture : ``run -> (replay, outputs)``.  None: :func:`cuda_capture` on
        a CUDA batch, and the body run as it is on a CPU batch.  Tests pass
        a stand-in to drive the plumbing on the CPU.

    Graphs are keyed by ``owner``'s identity, the batch's keys, shapes and
    dtypes, grad mode and the autocast state.  The outputs
    returned are fresh tensors, never the graph's: a caller may keep them
    across steps.  ``eager`` is the body, for comparison and debugging;
    ``captures`` counts the captures made.  A call's host work is three
    spans (``utils/spans.py``): ``fhpe.graph.lookup`` (the signature and
    the fingerprint's compare), then ``fhpe.graph.replay`` (copy-in,
    replay, output clones) or ``fhpe.graph.capture`` (the eager run and
    the capture).
    """

    def __init__(self, body: Callable[[object, dict], dict],
                 fingerprint: Callable[[object], tuple],
                 capture: Optional[Callable] = None):
        self.eager = body
        self._fingerprint = fingerprint
        self._capture = capture
        self._graphs: Dict[tuple, _Graph] = {}
        self.captures = 0

    def __call__(self, owner, batch: dict) -> dict:
        with span("fhpe.graph.lookup"):
            device = _batch_device(batch)
            capture = self._capture
            if capture is None and device.type == "cuda":
                capture = cuda_capture
            if capture is not None:
                key = _signature(owner, batch, device)
                g = self._graphs.get(key)
                if g is not None and g.fingerprint != self._fingerprint(owner):
                    g = None
        if capture is None:
            return self.eager(owner, batch)
        # a capture records on the current device, and a replay's copies
        # and clones run there: make it the batch's
        with current_device(device):
            if g is not None:
                with span("fhpe.graph.replay"):
                    for k, v in batch.items():
                        g.static[k].copy_(v, non_blocking=True)
                    g.replay()
                    _add_launches(g.launches)
                    return _fresh(g.out)
            # a stale graph's memory goes back before the new capture
            self._graphs.pop(key, None)
            for fn in list(_before_capture):
                fn()
            with span("fhpe.graph.capture"):
                return self._first_call(key, owner, batch, capture, device)

    def _first_call(self, key, owner, batch, capture, device) -> dict:
        with torch.inference_mode(False):
            static = {k: v.clone() for k, v in batch.items()}
        result = _fresh(_on_side_stream(
            device, lambda: self.eager(owner, static)))
        # the eager step made any state it lacked (Adam's moments)
        fingerprint = self._fingerprint(owner)
        before = _counter_values()
        replay, out = capture(lambda: self.eager(owner, static))
        recorded = [a - b for a, b in zip(_counter_values(), before)]
        _add_launches([-n for n in recorded])
        self._graphs[key] = _Graph(static, out, replay, fingerprint,
                                   recorded)
        self.captures += 1
        return result


def current_device(device):
    """A context that makes ``device`` the current CUDA device; nothing for
    another device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _on_side_stream(device, fn):
    """``fn()`` on a side stream ordered after the current one (the warm-up
    of PyTorch's capture recipe); the current stream waits for it."""
    if device.type != "cuda":
        return fn()
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    return out
