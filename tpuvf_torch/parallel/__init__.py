"""dp/sp sharding over several torch devices (port of ``tpuvf.parallel``):
`mesh` (the Mesh, make_mesh and the batch runner), `bands` (row bands and
their halos), `halo` (the standalone sharded blur)."""
