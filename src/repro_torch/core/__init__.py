"""Core of the port: topology, compression operators, objectives, gossip,
the flat engines and the simulator."""
