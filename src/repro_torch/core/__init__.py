"""Core library: the paper's MapReduce SVM on PyTorch."""
from repro_torch.core.kernel_fns import KernelConfig, apply_kernel
from repro_torch.core.svm import (BinarySVM, SolverParams, SVMConfig,
                                  decision_kernel, decision_linear,
                                  fit_binary, fit_binary_kernel,
                                  fit_binary_linear, kernel_matrix,
                                  predict_sign, solve_kernel_jobs,
                                  support_mask)
from repro_torch.core.mapreduce_svm import (CONVERGE_IMPLS, SHUFFLE_IMPLS,
                                            MapReduceSVM, MRSVMConfig,
                                            RoundResult, SVBuffer,
                                            decision_values, fit_mapreduce,
                                            init_sv_buffer, mapreduce_round,
                                            predict, sweep_round,
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
    "support_mask", "CONVERGE_IMPLS", "SHUFFLE_IMPLS", "MapReduceSVM",
    "MRSVMConfig", "RoundResult", "SVBuffer", "decision_values",
    "fit_mapreduce", "init_sv_buffer", "mapreduce_round", "predict",
    "sweep_round", "update_mapreduce",
    "OneVsOneSVM", "OneVsRestSVM", "confusion_matrix", "fit_one_vs_one",
    "fit_one_vs_rest", "converged", "empirical_risk", "hinge_loss",
    "zero_one_loss",
    "SweepOneVsRest", "SweepResult", "fit_mapreduce_sweep",
    "fit_one_vs_rest_sweep", "predict_sweep", "stack_params",
    "sweep_decision_values", "sweep_grid",
]
