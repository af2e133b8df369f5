"""Core library: the paper's MapReduce SVM on PyTorch."""
from repro_torch.core.kernel_fns import KernelConfig, apply_kernel
from repro_torch.core.svm import (BinarySVM, SolverParams, SVMConfig,
                                  decision_kernel, decision_linear,
                                  fit_binary, fit_binary_kernel,
                                  fit_binary_linear, kernel_matrix,
                                  predict_sign, solve_kernel_jobs,
                                  support_mask)
from repro_torch.core.mapreduce_svm import (CONVERGE_IMPLS, PACKED_SHUFFLES,
                                            SHUFFLE_IMPLS, MapReduceSVM,
                                            MRSVMConfig, RoundResult,
                                            SVBuffer, build_sharded_round,
                                            decision_values, fit_mapreduce,
                                            init_sv_buffer,
                                            make_sharded_round,
                                            mapreduce_round, pack_wire_rows,
                                            predict, resolve_topology,
                                            sweep_round, unpack_wire_rows,
                                            update_mapreduce)
from repro_torch.core.multiclass import (OneVsOneSVM, OneVsRestSVM,
                                         confusion_matrix, fit_one_vs_one,
                                         fit_one_vs_rest)
from repro_torch.core.risk import (converged, empirical_risk, hinge_loss,
                                   zero_one_loss)
from repro_torch.core.sweep import (SweepOneVsRest, SweepResult,
                                    fit_mapreduce_sweep,
                                    fit_one_vs_rest_sweep, predict_sweep,
                                    stack_params, sweep_decision_values,
                                    sweep_grid)

__all__ = [
    "KernelConfig", "apply_kernel", "BinarySVM", "SolverParams", "SVMConfig",
    "decision_kernel", "decision_linear", "fit_binary", "fit_binary_kernel",
    "fit_binary_linear", "kernel_matrix", "predict_sign", "solve_kernel_jobs",
    "support_mask", "CONVERGE_IMPLS", "PACKED_SHUFFLES", "SHUFFLE_IMPLS",
    "MapReduceSVM", "MRSVMConfig", "RoundResult", "SVBuffer",
    "build_sharded_round", "decision_values", "fit_mapreduce",
    "init_sv_buffer", "make_sharded_round", "mapreduce_round",
    "pack_wire_rows", "predict", "resolve_topology", "sweep_round",
    "unpack_wire_rows", "update_mapreduce",
    "OneVsOneSVM", "OneVsRestSVM", "confusion_matrix", "fit_one_vs_one",
    "fit_one_vs_rest", "converged", "empirical_risk", "hinge_loss",
    "zero_one_loss",
    "SweepOneVsRest", "SweepResult", "fit_mapreduce_sweep",
    "fit_one_vs_rest_sweep", "predict_sweep", "stack_params",
    "sweep_decision_values", "sweep_grid",
]
