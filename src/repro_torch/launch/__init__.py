"""Launchers: the serving and training drivers (``serve.py``,
``train.py``) and the dry run of every (arch × shape) cell on the
production mesh (``dryrun.py``, with its cells in ``specs.py`` and its
meshes in ``mesh.py``)."""
