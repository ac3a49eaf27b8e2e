"""Core NDPP math of the port: types, Youla, the proposal tree and the
speculative rejection sampler."""
from .rejection import (  # noqa: F401
    NDPPSampler,
    RejectionSample,
    auto_n_spec,
    det_ratio_exact,
    expected_trials,
    log_det_ratio,
    log_det_ratio_batch,
    preprocess,
    sample_batched_many,
)
from .tree import (  # noqa: F401
    SampleTree,
    construct_tree,
    proposal_eigens,
    sample_elementary_batch,
    sample_proposal_dpp_batch,
)
from .types import (  # noqa: F401
    NDPPParams,
    SpectralNDPP,
    d_from_sigma,
    dense_l,
    dense_l_hat,
    dense_l_spectral,
    x_from_sigma,
)
from .youla import spectral_from_params, youla_decompose_np  # noqa: F401
