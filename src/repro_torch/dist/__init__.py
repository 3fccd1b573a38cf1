"""Distribution helpers of the port (gradient compression; the mesh layer
is ROADMAP Queue 1 item 10)."""
