"""Core NDPP math of the port: types, Youla, the linear-time Cholesky
sampler, the proposal tree, the rejection samplers (sequential and
speculative), the fixed-size k-NDPP sampler, the dynamic-catalog proposal
and the MCMC chains, the tree-based ones unsharded or item-sharded over a
mesh; ONDPP learning, greedy MAP and conditioning."""
from .bilinear import (  # noqa: F401
    bilinear_scores,
    bilinear_scores_fast,
    conditional_inner_matrix,
    conditional_scores,
)
from .cholesky import (  # noqa: F401
    marginal_inner,
    marginal_inner_from_params,
    sample_cholesky,
    sample_cholesky_blocked,
    sample_cholesky_inner,
    sample_cholesky_params,
    sample_cholesky_spectral,
)
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
from .kdpp import (  # noqa: F401
    elementary_symmetric,
    elementary_symmetric_log,
    sample_fixed_size_e,
    sample_k_ndpp,
    sample_kdpp,
)
from .learning import (  # noqa: F401
    Baskets,
    init_ndpp,
    init_ondpp,
    item_frequencies,
    log_normalizer,
    ndpp_loss,
    ondpp_loss,
    project_constraints,
    symmetric_dpp_loss,
)
from .map_inference import (  # noqa: F401
    conditional_sample,
    greedy_map,
    mean_percentile_rank,
    mpr_frequency_baseline,
    next_item_scores,
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
    sample,
    sample_batch,
    sample_batched,
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
    sample_elementary,
    sample_elementary_batch,
    sample_elementary_batch_sharded,
    sample_elementary_dense,
    sample_proposal_dpp,
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
    ONDPPParams,
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
    youla_decompose,
    youla_decompose_np,
    youla_transform_np,
)
