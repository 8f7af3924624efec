"""Cache-policy objects of the port: the protocol, FreqCa and its family
(FreqCa-A, FreqCa-EB, TaylorSeer, FORA, FoCa, TeaCache) and ``none``.  Policy
objects are the construction route; the legacy
``repro_torch.core.cache.CachePolicy`` spec resolves to them."""
from repro_torch.core.policies.base import (ErrorFeedback,  # noqa: F401
                                            Policy, Ring, StepContext,
                                            lane_select)
from repro_torch.core.policies.foca import FoCaPolicy  # noqa: F401
from repro_torch.core.policies.fora import ForaPolicy  # noqa: F401
from repro_torch.core.policies.freqca import FreqCaPolicy  # noqa: F401
from repro_torch.core.policies.freqca_a import (  # noqa: F401
    FreqCaAdaptivePolicy)
from repro_torch.core.policies.freqca_eb import (ERROR_TIERS,  # noqa: F401
                                                 FreqCaErrorBudgetPolicy,
                                                 budget_tier)
from repro_torch.core.policies.none import NoCachePolicy  # noqa: F401
from repro_torch.core.policies.registry import (  # noqa: F401
    MixedBank, PolicyBank, UniformBank, available, bank, compatibility_key,
    register, resolve)
from repro_torch.core.policies.taylorseer import (  # noqa: F401
    TaylorSeerPolicy)
from repro_torch.core.policies.teacache import TeaCachePolicy  # noqa: F401
