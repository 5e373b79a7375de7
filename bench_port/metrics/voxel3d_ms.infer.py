"""Device ms per batch of the 3D nets: GenRe's 3D U-Net (``genre.refine``),
MarrNet-2 twice and the critic twice (``marrnet.marrnet2``,
``shapehd.net_noft``, ``shapehd.critic``; MarrNet-2's spans hold its
ResNet-18 encoder too), K3 included."""

from metrics._read import span_ms


def read(summary):
    return span_ms(summary, ("genre.refine", "marrnet.marrnet2",
                             "shapehd.net_noft", "shapehd.critic"))
