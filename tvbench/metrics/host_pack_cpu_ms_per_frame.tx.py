"""CPU time of the host collect and pack over the window, per frame
(cpu.sparse_unpack + cpu.unflatten + cpu.cavlc): the unpack and
unflatten on the collector threads and each slice's CAVLC pack on the
pack pool's threads."""

from tvbench.hostpath import per_frame_of


def read(rec):
    return per_frame_of(rec, ("cpu.sparse_unpack", "cpu.unflatten",
                              "cpu.cavlc"))
