"""Command-line launchers of the port: ``python -m repro_torch.launch.spatial``
(batched spatial analytics) and ``python -m repro_torch.launch.serve
--spatial`` (serving rounds, or ``--scheduler``'s streaming front door;
``--arch ARCH`` in place of ``--spatial`` serves an LM). They run on the
card unless given ``--device cpu``."""
