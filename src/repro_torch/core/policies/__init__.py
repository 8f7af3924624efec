"""Cache-policy objects of the port: the protocol, FreqCa and ``none``."""
from repro_torch.core.policies.base import (Policy, Ring,  # noqa: F401
                                            StepContext, lane_select)
from repro_torch.core.policies.freqca import FreqCaPolicy  # noqa: F401
from repro_torch.core.policies.none import NoCachePolicy  # noqa: F401
from repro_torch.core.policies.registry import (PolicyBank,  # noqa: F401
                                                UniformBank, bank,
                                                compatibility_key, resolve)
