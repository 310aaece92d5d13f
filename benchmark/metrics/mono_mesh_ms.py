"""Mean host time of one mesh extraction of the mono object pipeline (the
`mono_mesh` span: the voxel grid's decode and marching tetrahedra on the
host), in ms."""

from benchmark.metrics._common import mean_ms


def read(run):
    return mean_ms(run, "mono_mesh")
