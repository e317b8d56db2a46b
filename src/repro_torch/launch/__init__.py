"""Launch-side helpers: mapping a device mesh onto the machine hierarchy."""
