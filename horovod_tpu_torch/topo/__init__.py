"""The topology compositor's lowering half (``topo/compositor.py``): the
two-level schedules of every collective over a tuple of groups. The
planning half (``topo/model.py``, plan selection and pricing) is ROADMAP
A13."""
