"""Device energy costs (the JAX package's ``energy/costs.py``): what one
federated round (`DeviceCostModel`) and one inference request
(`DecodeCostModel`) debit the battery.  Compute cost comes from a FLOP
count (``from_flops``, ``from_params``) or from a `launch.dryrun` record
(``from_dryrun``: either package's records, whose keys are the same),
radio cost from the model's parameter bytes; ``energy_record`` is the
record's ``energy`` block.

Nominal constants (order-of-magnitude for an edge-class accelerator and a
wireless uplink; override per deployment):

* ``JOULES_PER_FLOP`` — 10 pJ/FLOP effective (≈100 GFLOPS/W device).
* ``JOULES_PER_BYTE_RADIO`` — 100 nJ/byte (~0.8 J per MB uplink).
* ``DEVICE_WATTS`` — 1 W sustained accelerator draw; converts *measured*
  seconds/token from the engine microbenchmarks into joules/token
  (``from_microbench``).

Fields are floats or numpy arrays (heterogeneous fleets); ``request_cost``
is plain arithmetic on them.
"""
from __future__ import annotations

import dataclasses

JOULES_PER_FLOP = 1e-11
JOULES_PER_BYTE_RADIO = 1e-7
DEVICE_WATTS = 1.0


@dataclasses.dataclass(frozen=True)
class DeviceCostModel:
    """Joules debited per federated-round component."""

    joules_per_step: float          # one local optimizer step (T per round)
    joules_per_upload: float        # send the model delta to the server
    joules_per_download: float = 0.0  # fetch the global model

    def round_cost(self, local_steps: int) -> float:
        """Total joules for one participated round of ``local_steps``
        steps."""
        return (local_steps * self.joules_per_step + self.joules_per_upload
                + self.joules_per_download)


def from_flops(flops_per_step: float, upload_bytes: float,
               download_bytes: float = 0.0,
               joules_per_flop: float = JOULES_PER_FLOP,
               joules_per_byte: float = JOULES_PER_BYTE_RADIO
               ) -> DeviceCostModel:
    """Cost model from raw workload counts."""
    return DeviceCostModel(
        joules_per_step=flops_per_step * joules_per_flop,
        joules_per_upload=upload_bytes * joules_per_byte,
        joules_per_download=download_bytes * joules_per_byte,
    )


def from_dryrun(record: dict, local_steps: int = 5,
                bytes_per_param: float = 2.0,
                joules_per_flop: float = JOULES_PER_FLOP,
                joules_per_byte: float = JOULES_PER_BYTE_RADIO
                ) -> DeviceCostModel:
    """Cost model from one `launch.dryrun` record: its
    ``cost.flops_per_device`` covers the whole local phase of
    ``local_steps`` steps; the upload and the download are the model,
    ``params_active`` parameters at ``bytes_per_param`` (bf16 default)."""
    flops_total = float(record["cost"]["flops_per_device"])
    params = float(record.get("params_active") or record["params_analytic"])
    return from_flops(flops_total / max(local_steps, 1),
                      params * bytes_per_param,
                      download_bytes=params * bytes_per_param,
                      joules_per_flop=joules_per_flop,
                      joules_per_byte=joules_per_byte)


@dataclasses.dataclass(frozen=True)
class DecodeCostModel:
    """Joules debited per inference-request component: one prefill over the
    prompt, one decode step per generated token, one response upload."""

    joules_per_prefill_token: float
    joules_per_decode_step: float           # one generated token
    joules_per_response_upload: float = 0.0

    def request_cost(self, prompt_tokens, decode_tokens):
        """Joules for one request: ``prompt_tokens`` prefilled,
        ``decode_tokens`` generated, one response uploaded."""
        return (prompt_tokens * self.joules_per_prefill_token
                + decode_tokens * self.joules_per_decode_step
                + self.joules_per_response_upload)

    @classmethod
    def from_params(cls, num_params: float, bytes_per_response: float = 512.0,
                    joules_per_flop: float = JOULES_PER_FLOP,
                    joules_per_byte: float = JOULES_PER_BYTE_RADIO
                    ) -> "DecodeCostModel":
        """Analytic model: ~2*N FLOPs per token for both the prefill and the
        decode matmuls of an N-(active-)parameter decoder."""
        per_tok = 2.0 * num_params * joules_per_flop
        return cls(joules_per_prefill_token=per_tok,
                   joules_per_decode_step=per_tok,
                   joules_per_response_upload=(bytes_per_response
                                               * joules_per_byte))

    @classmethod
    def from_dryrun(cls, decode_record: dict,
                    prefill_record: dict | None = None,
                    batch: int | None = None, prompt_len: int | None = None,
                    bytes_per_response: float = 512.0,
                    joules_per_flop: float = JOULES_PER_FLOP,
                    joules_per_byte: float = JOULES_PER_BYTE_RADIO
                    ) -> "DecodeCostModel":
        """Decode-path cost model from `launch.dryrun` records.  A
        ``decode`` record's ``cost.flops_per_device`` is one decode step over
        the shape's whole batch, so a generated token costs it over the
        batch; a ``prefill`` record prices prompt tokens as flops / (batch
        x seq), and without one a prompt token costs a generated one.
        ``batch`` / ``prompt_len`` override the shape registry's figures
        for ``record["shape"]`` (a record of a shape outside the registry
        needs both)."""
        from repro_torch.configs.base import INPUT_SHAPES

        b = (batch if batch is not None
             else INPUT_SHAPES[decode_record["shape"]].global_batch)
        dec_flops = float(decode_record["cost"]["flops_per_device"])
        per_decode = dec_flops / max(b, 1) * joules_per_flop
        if prefill_record is not None:
            pb, ps = batch, prompt_len
            if pb is None or ps is None:
                shape = INPUT_SHAPES[prefill_record["shape"]]
                pb = shape.global_batch if pb is None else pb
                ps = shape.seq_len if ps is None else ps
            pre_flops = float(prefill_record["cost"]["flops_per_device"])
            per_prefill = pre_flops / max(pb * ps, 1) * joules_per_flop
        else:
            per_prefill = per_decode
        return cls(joules_per_prefill_token=per_prefill,
                   joules_per_decode_step=per_decode,
                   joules_per_response_upload=(bytes_per_response
                                               * joules_per_byte))

    @classmethod
    def from_microbench(cls, seconds_per_prefill_token: float,
                        seconds_per_decode_token: float,
                        watts: float = DEVICE_WATTS,
                        bytes_per_response: float = 512.0,
                        joules_per_byte: float = JOULES_PER_BYTE_RADIO
                        ) -> "DecodeCostModel":
        """Cost model from *measured* per-stage engine timings, priced at a
        sustained device draw: J/token = W × s/token.  The radio upload
        stays byte-priced (the microbench times compute, not the uplink)."""
        for name, s in (("prefill", seconds_per_prefill_token),
                        ("decode", seconds_per_decode_token)):
            if not s > 0.0:
                raise ValueError(f"measured {name} seconds/token must be "
                                 f"> 0 (got {s})")
        return cls(joules_per_prefill_token=watts * seconds_per_prefill_token,
                   joules_per_decode_step=watts * seconds_per_decode_token,
                   joules_per_response_upload=(bytes_per_response
                                               * joules_per_byte))


def energy_record(flops_per_device: float, num_params: float,
                  local_steps: int, bytes_per_param: float = 2.0) -> dict:
    """The `launch.dryrun` record's ``energy`` block: nominal joules of the
    workload at the constants above."""
    m = from_flops(flops_per_device / max(local_steps, 1),
                   num_params * bytes_per_param,
                   download_bytes=num_params * bytes_per_param)
    return {
        "joules_per_local_step": m.joules_per_step,
        "joules_per_upload": m.joules_per_upload,
        "joules_per_round": m.round_cost(local_steps),
        "assumed_joules_per_flop": JOULES_PER_FLOP,
        "assumed_joules_per_byte_radio": JOULES_PER_BYTE_RADIO,
    }
