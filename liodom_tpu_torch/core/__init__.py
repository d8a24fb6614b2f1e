"""Core types of the port: configuration, scan containers, SE(3) math and
the synthetic scene generator."""
