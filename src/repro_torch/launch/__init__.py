"""Entry points: the serving and training launchers, the step builders
they share (``launch.steps``) and the serving mesh (``launch.mesh``)."""
