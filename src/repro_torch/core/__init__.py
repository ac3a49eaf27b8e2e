"""Core NDPP math of the port: types, Youla, the proposal tree, the
speculative rejection sampler, the dynamic-catalog proposal and the MCMC
chains, each unsharded or item-sharded over a mesh."""
from .bilinear import bilinear_scores, bilinear_scores_fast  # noqa: F401
from .dynamic import (  # noqa: F401
    DualProposal,
    auto_n_spec_dynamic,
    build_dual_proposal,
    dual_eigens,
    dual_rows,
    expected_trials_dynamic,
    sample_dynamic_many,
    update_proposal,
)
from .mcmc import (  # noqa: F401
    MCMCSample,
    MCMCState,
    add_ratio,
    init_empty,
    init_greedy,
    reanchor,
    remove_ratio,
    run_chains,
    run_chains_sharded,
    sample_mcmc,
    score_matrix,
    swap_ratio,
    swap_score_matrix,
)
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
    shard_sampler,
)
from .tree import (  # noqa: F401
    SampleTree,
    ShardedTree,
    construct_tree,
    dual_q0,
    gather_tree,
    proposal_eigens,
    sample_elementary_batch,
    sample_elementary_batch_sharded,
    sample_proposal_dpp_batch,
    sample_proposal_dpp_batch_sharded,
    shard_spectral,
    shard_tree,
    tree_shard_specs,
    update_rows,
    update_rows_sharded,
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
from .youla import (  # noqa: F401
    spectral_from_params,
    spectral_from_transform,
    youla_decompose_np,
    youla_transform_np,
)
