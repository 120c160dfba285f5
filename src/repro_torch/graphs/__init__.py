"""Graph containers, generators and the named datasets (numpy)."""
