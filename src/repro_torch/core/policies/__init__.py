"""Cache-policy objects of the port: the protocol, FreqCa and its family
(FreqCa-A, TaylorSeer, FORA, FoCa, TeaCache) and ``none``.  Policy
objects are the construction route; the legacy
``repro_torch.core.cache.CachePolicy`` spec resolves to them."""
from repro_torch.core.policies.base import (Policy, Ring,  # noqa: F401
                                            StepContext, lane_select)
from repro_torch.core.policies.foca import FoCaPolicy  # noqa: F401
from repro_torch.core.policies.fora import ForaPolicy  # noqa: F401
from repro_torch.core.policies.freqca import FreqCaPolicy  # noqa: F401
from repro_torch.core.policies.freqca_a import (  # noqa: F401
    FreqCaAdaptivePolicy)
from repro_torch.core.policies.none import NoCachePolicy  # noqa: F401
from repro_torch.core.policies.registry import (PolicyBank,  # noqa: F401
                                                UniformBank, available, bank,
                                                compatibility_key, register,
                                                resolve)
from repro_torch.core.policies.taylorseer import (  # noqa: F401
    TaylorSeerPolicy)
from repro_torch.core.policies.teacache import TeaCachePolicy  # noqa: F401
