"""The parts of the p2p layer the port needs so far: the flow-rate
monitor of fast sync's peer rate check. Switch, peers and reactors wait
for the p2p slice."""
