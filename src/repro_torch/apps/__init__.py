"""Paper workloads (§V) expressed as blocked-array DAGs with JAX payloads."""
from repro_torch.apps.dynamic import (
    dynamic_tree_reduction_dag,
    dynamic_tree_reduction_expected,
    static_tree_reduction_equivalent,
)
from repro_torch.apps.gemm import gemm_dag
from repro_torch.apps.svc import svc_dag
from repro_torch.apps.svd import tsqr_svd_dag, randomized_svd_dag
from repro_torch.apps.tree_reduction import tree_reduction_dag

__all__ = [
    "tree_reduction_dag",
    "dynamic_tree_reduction_dag",
    "dynamic_tree_reduction_expected",
    "static_tree_reduction_equivalent",
    "gemm_dag",
    "tsqr_svd_dag",
    "randomized_svd_dag",
    "svc_dag",
]
