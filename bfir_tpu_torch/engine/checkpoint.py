"""Stream-state checkpoint and resume.

Counterpart of ``bfir_tpu/engine/checkpoint.py``: the complex engine's
``ConvolverState``, with the dither state and the overflow counters, round
trip through an ``.npz`` so that a long render or a live stream resumes
where it stopped. The reference plugin has no such checkpoint.

The file keeps the reference's keys (``ring_re``, ``ring_im``,
``prev_block``, ``blockcounter``, ``d_e0``, ``d_e1``, ``d_prev_byte``,
``d_key``, ``of_n``, ``of_largest``, ``of_intlargest``), so that each
package loads the other's files. The port's dither draws from a
``torch.Generator``, not a threefry key: its state goes under a key of its
own, ``d_generator``, beside the kind of device that wrote it,
``d_generator_device`` (``"cpu"`` or ``"cuda"``: the two generators' states
differ), and ``d_key`` holds the uint32 pair ``[0, seed]`` (the form of the
reference's ``PRNGKey(seed)``) from the generator's initial seed.
``load_state`` restores the generator's state where the file has one from
the loading device's kind; otherwise it seeds a generator from ``d_key``'s
last word, as ``convert.dither_state_from_numpy`` seeds one (new noise, the
error feedback carried over), and logs that it did where a state of the
other kind was dropped.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from bfir_tpu_torch import convert
from bfir_tpu_torch.core import convolver as cv
from bfir_tpu_torch.ops import dither as dth
from bfir_tpu_torch.utils.device import resolve_device
from bfir_tpu_torch.utils.logging import pinfo


def save_state(path: str, state: cv.ConvolverState,
               dither_state: Optional[dth.DitherState] = None,
               overflow: Optional[dth.OverflowStats] = None) -> None:
    ring = state.spectra_ring.detach().cpu()
    data = {
        "ring_re": ring.real.numpy(),
        "ring_im": ring.imag.numpy(),
        "prev_block": convert.tensor_to_numpy(state.prev_block),
        "blockcounter": np.asarray(state.blockcounter, dtype=np.int32),
    }
    if dither_state is not None:
        gen = dither_state.generator
        data.update(
            d_e0=convert.tensor_to_numpy(dither_state.e0),
            d_e1=convert.tensor_to_numpy(dither_state.e1),
            d_prev_byte=convert.tensor_to_numpy(dither_state.prev_byte),
            d_key=np.array([0, gen.initial_seed() & 0xFFFFFFFF], np.uint32),
            d_generator=gen.get_state().numpy(),
            d_generator_device=np.array(gen.device.type),
        )
    if overflow is not None:
        data.update(
            of_n=convert.tensor_to_numpy(overflow.n_overflows),
            of_largest=convert.tensor_to_numpy(overflow.largest),
            of_intlargest=convert.tensor_to_numpy(overflow.intlargest),
        )
    np.savez(path, **data)


def _dither_state(z, device: torch.device) -> dth.DitherState:
    fields = SimpleNamespace(e0=z["d_e0"], e1=z["d_e1"],
                             prev_byte=z["d_prev_byte"])
    st = convert.dither_state_from_numpy(fields, device,
                                         seed=int(z["d_key"][-1]))
    if "d_generator" in z:
        kind = str(z["d_generator_device"])
        if kind == device.type:
            st.generator.set_state(
                torch.from_numpy(np.array(z["d_generator"], np.uint8)))
        else:
            pinfo("Checkpoint dither generator was saved on %s, loading on "
                  "%s: reseeded from d_key (new noise).", kind, device.type)
    return st


def load_state(path: str, *, device) -> Tuple[
        cv.ConvolverState, Optional[dth.DitherState],
        Optional[dth.OverflowStats]]:
    dev = resolve_device(device)
    with np.load(path) as z:
        ring = torch.complex(torch.from_numpy(z["ring_re"]),
                             torch.from_numpy(z["ring_im"]))
        state = cv.ConvolverState(
            spectra_ring=ring.to(dev),
            prev_block=convert.tensor_from_numpy(z["prev_block"], dev),
            blockcounter=int(z["blockcounter"]))
        dither_state = _dither_state(z, dev) if "d_e0" in z else None
        overflow = None
        if "of_n" in z:
            overflow = convert.overflow_stats_from_numpy(
                (z["of_n"], z["of_largest"], z["of_intlargest"]), dev)
    return state, dither_state, overflow
