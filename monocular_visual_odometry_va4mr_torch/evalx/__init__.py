from .ate import ate_rmse, rpe_stats, umeyama_alignment  # noqa: F401
