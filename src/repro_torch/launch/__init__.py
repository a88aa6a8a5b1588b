"""Entry points: the serving and training launchers, and the step
builders they share (``launch.steps``)."""
