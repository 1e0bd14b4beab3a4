"""Record-only spans inside the round, the aggregate and the MoE layer.

``span(name)`` marks a stretch of the program as a
``torch.profiler.record_function`` range while ``recording()`` is on, and
is a shared ``contextlib.nullcontext()`` otherwise (the default): a site
then costs one attribute read. A span fences nothing and reads nothing
back to the host: it is a host event in the profiler's trace, on the
same clock as the card's kernels, so a profiler run with the switch on
can put each kernel (and each idle gap of the card) down to the span
that launched it. The switch is process-wide, so a span entered on
autograd's own thread (remat's recompute in the backward) records too.

``SPAN_NAMES`` lists every span, in the way ``PHASE_NAMES`` lists the
phases of ``RoundTrace``:

    round.stage        ``Trainer.run``: the round's host staging, from the
                       top of the round to the step call (membership, the
                       next batch and its copy to the card, the masks)
    round.local_steps  the tau local steps (``_round_parts.run_scan``):
                       forward, remat, backward, the update, energies
    round.aggregate    the rule's call and the state's assembly: theta,
                       every leaf's encode, the Eq. 10 kernel
    round.readback     ``Trainer.run``: from the step's return to the end
                       of the round (the metrics' readback, history, the
                       Judge scores, hooks)
    agg.encode         a codec's encode of one leaf (``core/backends.py``)
    moe.route          ``moe_ffn``'s router, top-k, aux losses, slot ranks
    moe.dispatch       the gather into the (E, C, d) slot table
    moe.experts        the three expert products and the SiLU
    moe.combine        the gather back and the gate weighting
"""
from __future__ import annotations

import contextlib

import torch

SPAN_NAMES = ("round.stage", "round.local_steps", "round.aggregate",
              "round.readback", "agg.encode", "moe.route", "moe.dispatch",
              "moe.experts", "moe.combine")

_OFF = contextlib.nullcontext()


class _Switch:
    on = False


_SWITCH = _Switch()


def span(name: str):
    """A ``record_function`` range named ``name`` while recording, else
    the shared null context."""
    if not _SWITCH.on:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def recording(on: bool = True):
    """Spans record (``on``) inside the block, on every thread; the
    previous setting comes back after it."""
    prev, _SWITCH.on = _SWITCH.on, on
    try:
        yield
    finally:
        _SWITCH.on = prev
