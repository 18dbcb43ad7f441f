"""Local linear-attention math and the device policy of the port."""
