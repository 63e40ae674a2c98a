"""The checks and measurements the port runs beside its package:
``e2e_validation`` (the train CLI's steady-state rate beside ``bench``) and
``fid_descent_validation`` (prune, then retrain, and the in-loop FID's
descent), each through its CLIs, with the seeded files they read
(``fixtures``); ``trace_op_time`` (a ``torch.profiler`` trace by kernel
category, op and kernel, with executed FLOPs) and ``bench_loader`` (the
training data's images/s through each loader path)."""
