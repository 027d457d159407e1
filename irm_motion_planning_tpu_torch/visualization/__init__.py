"""Visualization (counterpart of irm_motion_planning_tpu/visualization):
plots.py, animate.py and cli.py.  matplotlib is imported only inside the
drawing functions, so nothing else of the port needs it."""
