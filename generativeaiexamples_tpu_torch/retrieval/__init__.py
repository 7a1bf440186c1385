"""Vector stores: the interface, the in-memory numpy store, and the exact
store on the card (``gpu``)."""
