"""Physics routines of the port: SATUR, CUADJTQS and CLOUDSC2."""
