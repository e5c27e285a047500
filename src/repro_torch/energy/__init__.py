"""Energy accounting of the port: decode-path costs in this slice."""
from repro_torch.energy.costs import (DEVICE_WATTS, JOULES_PER_BYTE_RADIO,
                                      JOULES_PER_FLOP, DecodeCostModel)

__all__ = ["DEVICE_WATTS", "JOULES_PER_BYTE_RADIO", "JOULES_PER_FLOP",
           "DecodeCostModel"]
