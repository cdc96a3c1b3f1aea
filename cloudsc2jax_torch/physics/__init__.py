"""Physics routines of the port: SATUR and the CLOUDSC2 interface."""
