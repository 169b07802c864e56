"""Control-plane core of the port: the resource view and intersection
planner, events, shadow worlds, the warm world pool and the live
resharder."""
