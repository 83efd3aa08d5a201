"""Whole-sequence VO (``batch``), the SLAM back end's pose graph, windowed
BA and segments, and the multi-device layer: ``mesh`` (meshes of device
slots, process-group start-up, and the ``shard`` / ``replicate`` /
``psum`` / ``gather`` that the mesh forms of ``batch``, ``segments``,
``posegraph``, ``windowed``, ``loopclosure`` and
``solver.residual_system_point_sharded`` run on) and ``pipeline``
(two-stage build/solve replay)."""
