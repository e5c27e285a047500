"""Device energy costs (the JAX package's ``energy/costs.py``): what one
federated round (`DeviceCostModel`) and one inference request
(`DecodeCostModel`) debit the battery.  ``from_dryrun`` waits for the
dry-run pipeline (``ROADMAP.md`` Queue 1 item 27).

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
