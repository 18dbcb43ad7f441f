"""Model of the port: layers, blocks, the layer stack, and the weight
bridge from the reference's params."""
