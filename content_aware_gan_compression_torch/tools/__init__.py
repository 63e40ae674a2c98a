"""The checks the port runs beside its package, each through its CLIs:
``e2e_validation`` (the train CLI's steady-state rate beside ``bench``) and
``fid_descent_validation`` (prune, then retrain, and the in-loop FID's
descent), with the seeded files they read (``fixtures``)."""
